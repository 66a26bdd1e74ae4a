"""95th percentile of every gap between two consecutive output tokens of
one request, both emitted in the window (a prefill that stalls the pool
lies inside such a gap)."""
from bench.harness import stats


def read(r):
    v = stats.gaps([s.stamps for s in r.run.served], r.run.t0, r.run.t1)
    return 1e3 * stats.percentile(v, 95) if v else None
