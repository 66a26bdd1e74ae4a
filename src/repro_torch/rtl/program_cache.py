"""One locked LRU of compiled programs, shared by every staged executor
(port of ``repro/rtl/program_cache.py``).

The RTL emulator (:mod:`repro_torch.rtl.emulator`), the multi-design
emulator (:mod:`repro_torch.rtl.multi`) and the serving shard layer
(:mod:`repro_torch.serving.shard`) cache programs keyed by what the program
was built for, and all are hit from farm worker threads. On CUDA a program
is one ``torch.cuda.CUDAGraph`` of the graph walk
(:mod:`repro_torch.rtl.cuda_graph`); dropping it from this cache frees the
graph and its memory pool.

The LRU is also the unit of *program sharing*: isomorphic designs (same
:func:`repro_torch.rtl.ir.iso_key`) run identical programs once weights are
the program's operands, so handing several emulators one shared
``ProgramLRU`` makes K candidate designs build exactly once per
``(iso_key, mode, device, shape)`` — the multi-design emulation contract
(DESIGN.md §15).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Tuple


class ProgramLRU:
    """Thread-safe least-recently-used cache of compiled programs.

    ``get_or_build(key, factory)`` returns ``(program, hit, n_evicted)``:
    on a miss the factory runs *under the lock* (holding the lock keeps two
    threads from building the same key twice), the entry is inserted
    most-recently-used, and the oldest entries are evicted down to
    ``max_programs``.  Hits refresh recency.  ``key in lru`` is a
    read-only probe that does not touch recency order, so affinity
    routers can probe every pool member side-effect free.
    """

    def __init__(self, max_programs: int = 8):
        if max_programs < 1:
            raise ValueError(f"max_programs must be >= 1, got {max_programs}")
        self.max_programs = max_programs
        self._programs: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key: Hashable, factory: Callable[[], Any]
                     ) -> Tuple[Any, bool, int]:
        with self._lock:
            prog = self._programs.pop(key, None)
            hit = prog is not None
            evicted = 0
            if prog is None:
                self.misses += 1
                prog = factory()
                while len(self._programs) >= self.max_programs:
                    self._programs.popitem(last=False)
                    evicted += 1
                self.evictions += evicted
            else:
                self.hits += 1
            self._programs[key] = prog   # (re)insert most-recently-used
        return prog, hit, evicted

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._programs

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)

    def clear(self) -> None:
        """Drop every cached program (e.g. after an SEU corrupts the
        memories a program's operands are built from)."""
        with self._lock:
            self._programs.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "size": len(self._programs)}

    def __repr__(self) -> str:
        return (f"ProgramLRU(max_programs={self.max_programs}, "
                f"size={len(self)}, hits={self.hits}, "
                f"misses={self.misses}, evictions={self.evictions})")
