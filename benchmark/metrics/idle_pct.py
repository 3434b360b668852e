"""The share (%) of the traced stretch in which no operation ran on the
device: 100 * (1 - busy / window)."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
