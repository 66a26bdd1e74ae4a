"""Seconds from the process's start to the window's opening: imports,
the kernels' load (their build in a checkout's first run), the weights'
draw, the warm-up and, in a closed loop, the pool's admission."""


def read(r):
    return r.run.setup_s
