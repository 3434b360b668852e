"""Probe rows of every query answered in the window, over the window's
seconds (host clock, from the window's opening to the last answer)."""


def read(run):
    return run.rows / run.window_s
