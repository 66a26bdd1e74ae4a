"""The return of dropped CUDA Graph pools (ROADMAP §C10), on the CPU.

A CUDA program (``rtl/cuda_graph.py::CapturedProgram``) captures inside
``cuda_graph.capturing()``, the process-wide capture lock, and
``cuda_graph.track`` counts it as dropped once it is collected; the next
capture then returns the caching allocator's free blocks with one
``torch.cuda.empty_cache()``, under the lock, before its
``capture_begin``. Here the emulator runs on the CPU, where its programs
are the eager walk, so ``emulator.EagerProgram`` is replaced by a program
whose build passes through the same capture section and which is tracked
the same way, and ``torch.cuda.empty_cache`` by a recorder: every way a
program is dropped (eviction, ``ProgramLRU.clear``, ``flip_bit``, its
emulator collected) is followed by exactly one release, just before the
next capture, and no release happens while a capture holds the lock.
"""
import gc
import threading

import numpy as np
import pytest
import torch

from repro_torch.rtl import cuda_graph
from repro_torch.rtl import emulator as em_mod
from repro_torch.rtl.emulator import RTLEmulator
from repro_torch.verify.vectors import canonical_graph


@pytest.fixture
def events(monkeypatch):
    """The order of captures and releases; the release state starts
    clean."""
    log = []

    class StubProgram(em_mod.EagerProgram):
        """The eager walk, built through the capture section and tracked,
        as a CUDA program is."""

        def __init__(self, walk):
            super().__init__(walk)
            cuda_graph.track(self)
            with cuda_graph.capturing():
                log.append("capture")

    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: log.append("release"))
    gc.collect()
    with cuda_graph.capturing():     # any earlier drop is released here
        pass
    monkeypatch.setattr(em_mod, "EagerProgram", StubProgram)
    log.clear()
    return log


def _emulator(max_programs=8):
    graph, _, _ = canonical_graph("elastic-lstm")
    return RTLEmulator(graph, max_programs=max_programs, device="cpu")


def _x(batch):
    return np.random.default_rng(batch).standard_normal(
        (batch, 6, 1)).astype(np.float32)


def test_no_release_without_a_dropped_program(events):
    em = _emulator()
    em.run(_x(4))
    em.run(_x(5))
    em.run(_x(4))                               # a hit: no capture
    gc.collect()
    assert events == ["capture", "capture"]


def test_an_evicted_program_is_released_once_before_the_next_capture(
        events):
    em = _emulator(max_programs=1)
    em.run(_x(4))
    em.run(_x(5))                  # builds, then evicts the 4-row program
    gc.collect()
    assert events == ["capture", "capture"]
    em.run(_x(4))                  # builds, then evicts the 5-row program
    em.run(_x(5))
    assert events == ["capture", "capture", "release", "capture",
                      "release", "capture"]
    assert em.cache_stats()["evictions"] == 3


def test_clear_releases_once_however_many_programs_went(events):
    em = _emulator()
    for b in (3, 4, 5):
        em.run(_x(b))
    em._programs.clear()
    gc.collect()
    assert events == ["capture"] * 3
    em.run(_x(3))
    em.run(_x(4))
    assert events == ["capture"] * 3 + ["release", "capture", "capture"]


def test_a_flip_releases_before_the_rebuild(events):
    em = _emulator()
    em.run(_x(4))
    em.flip_bit("lstm_cell_l0", "w", 0, 7)
    assert events == ["capture"]
    em.run(_x(4))
    assert events == ["capture", "release", "capture"]


def test_a_collected_emulator_releases_its_programs(events):
    em = _emulator()
    em.run(_x(4))
    em.run(_x(5))
    del em
    gc.collect()
    assert events == ["capture", "capture"]
    _emulator().run(_x(4))
    assert events == ["capture", "capture", "release", "capture"]


def test_no_release_while_a_capture_holds_the_lock(events):
    """A program dropped while another thread captures is released by the
    next capture, after that capture ends; a finalizer that runs inside a
    capture (here: in the capturing thread itself) only counts."""
    inside, leave = threading.Event(), threading.Event()

    class Dropped:
        pass

    def first():
        with cuda_graph.capturing():
            events.append("A in")
            inside.set()
            obj = Dropped()
            cuda_graph.track(obj)
            del obj                        # counted while A holds the lock
            gc.collect()
            leave.wait(30)
            events.append("A out")

    def second():
        inside.wait(30)
        with cuda_graph.capturing():
            events.append("B in")

    a, b = threading.Thread(target=first), threading.Thread(target=second)
    a.start()
    b.start()
    inside.wait(30)
    b.join(0.3)                            # B waits for the lock
    assert b.is_alive() and events == ["A in"]
    leave.set()
    a.join(30)
    b.join(30)
    assert not a.is_alive() and not b.is_alive()
    assert events == ["A in", "A out", "release", "B in"]


def test_a_program_that_cannot_capture_refuses_the_cpu():
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        cuda_graph.CapturedProgram(lambda p: lambda x: {}, torch.zeros(2),
                                   {}, None)
