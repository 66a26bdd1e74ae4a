"""Share of the profiled slice in which no kernel, copy or memset ran on
the device, in a cell whose traffic is long prompts."""


def read(r):
    t = r.run.trace
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)
