"""Whether what the timed path served is right, decided once the window has
closed and the server is freed.

A sample of the served requests, drawn from the seed, always holding the
one with the most tokens served, grows until it holds ``check_tokens``
served tokens. Finished requests come first; requests still decoding at
the close are judged on the tokens they had served, where the finished
ones hold too few (a long decode outlasts the window). For each, the plain
reference runs once over the prompt and its served tokens, and each
served token's gap below the reference's best logit at its position is
read in units of that position's logits' standard deviation. The widest
gap is the number compared with the cell's limit (greedy serving: the
program's own first choice should be the reference's, up to rounding near
ties).

The control reads the same gap of the token that the reference computed a
precision below the configuration's (float8 products) puts first.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.harness.serve import Run, Served


@dataclass
class Verdict:
    widest_gap: float
    limit: float
    sampled: int
    tokens: int
    control_gap: Optional[float] = None

    @property
    def correct(self) -> bool:
        return bool(self.widest_gap <= self.limit)


def sample(served: List[Served], seed: int, tokens: int) -> List[Served]:
    """The requests to judge (see the module's doc)."""
    rng = np.random.default_rng(seed)
    have = [s for s in served if s.tokens]
    if not have:
        return []
    longest = max(have, key=lambda s: (len(s.tokens), -s.rid))
    done = [s for s in have if s.done and s is not longest]
    live = [s for s in have if not s.done and s is not longest]
    order = ([done[i] for i in rng.permutation(len(done))]
             + [live[i] for i in rng.permutation(len(live))])
    out, n = [longest], len(longest.tokens)
    for s in order:
        if n >= tokens:
            break
        out.append(s)
        n += len(s.tokens)
    return out


def _gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Each row's best logit minus the chosen token's, over the row's
    standard deviation."""
    best = ref.max(-1).values
    got = ref.gather(-1, chosen[:, None])[:, 0]
    return (best - got) / ref.std(-1)


def judge(run: Run, weights: Dict, config: Dict, model: ModuleType,
          seed: int, mix: Dict, device, control: bool = False) -> Verdict:
    """The run's widest gap (and, with ``control``, the control's) over
    the sample."""
    picked = sample(run.served, seed, mix["check_tokens"])
    widest, ctrl, n = 0.0, 0.0, 0
    for s in picked:
        seq = torch.tensor(s.req.prompt + s.tokens[:-1], dtype=torch.int64,
                           device=device)
        start = len(s.req.prompt) - 1
        served = torch.tensor(s.tokens, dtype=torch.int64, device=device)
        with torch.no_grad():
            ref = model.logits(weights, config, seq, start)
            widest = max(widest, _gaps(ref, served).max().item())
            if control:
                low = model.logits(weights, config, seq, start,
                                   mm=model.mm_fp8)
                ctrl = max(ctrl, _gaps(ref, low.argmax(-1)).max().item())
        n += len(s.tokens)
        del ref
    return Verdict(widest_gap=widest, limit=float(mix["gap_limit"]),
                   sampled=len(picked), tokens=n,
                   control_gap=ctrl if control else None)


def failed(run: Run, vocab: int) -> int:
    """Finished requests that did not emit exactly their length of valid
    tokens."""
    return sum(1 for s in run.served if s.done and (
        len(s.tokens) != s.req.out_len
        or not all(0 <= t < vocab for t in s.tokens)))
