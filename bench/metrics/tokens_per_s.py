"""Output tokens emitted in the window over the window's seconds."""
from bench.harness import stats


def read(r):
    run = r.run
    return (stats.tokens_in([s.stamps for s in run.served], run.t0, run.t1)
            / (run.t1 - run.t0))
