"""90th percentile of a request's wait in the server's queue: due time to
the start of its ``server.prefill`` span (``runtime/server.py``)."""
from bench.harness import stats


def read(r):
    due = {s.rid: s.due for s in r.run.served}
    v = [sp.start - due[sp.attrs["rid"]] for sp in r.spans("server.prefill")
         if sp.attrs["rid"] in due]
    return 1e3 * stats.percentile(v, 90) if v else None
