"""Seconds from the process's start to the window's opening: imports, the
card's start, the kernels' load (and build, in a checkout's first run),
the inputs, the port's tables and the warm-up."""


def read(run):
    return run.setup_s
