"""90th percentile, over every request due in the window, of first token
minus due time (a request with no first token by the window's end counts
at the end)."""
from bench.harness import stats


def read(r):
    run = r.run
    v = stats.ttfts([s.due for s in run.served],
                    [s.stamps[0] if s.stamps else None for s in run.served],
                    run.t0, run.t1)
    return 1e3 * stats.percentile(v, 90) if v else None
