"""Output tokens emitted in the traced window over its seconds, in a cell
whose host-paced rate spreads too widely between runs to stand end to end
(PERF.md section 2): the same count as ``tokens_per_s``."""
from bench.harness import stats


def read(r):
    run = r.run
    return (stats.tokens_in([s.stamps for s in run.served], run.t0, run.t1)
            / (run.t1 - run.t0))
