"""Mean host time of the window's decode forwards (``model.forward`` spans
with ``mode`` "decode", ``runtime/server.py``): the host's time to enqueue
one tick's kernels, milliseconds (a reading near the tick's device time
means the forward waits on the device somewhere)."""


def read(r):
    v = [sp.end - sp.start for sp in r.spans("model.forward")
         if sp.attrs["mode"] == "decode"]
    return 1e3 * sum(v) / len(v) if v else None
