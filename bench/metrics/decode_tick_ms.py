"""Mean ``server.decode`` span in the window, milliseconds."""


def read(r):
    v = [sp.end - sp.start for sp in r.spans("server.decode")]
    return 1e3 * sum(v) / len(v) if v else None
