"""The compacted chunks' fill (%): the live lanes the LP ladder's stages
hold over their widths, summed over every stage of the device's
stretch's recorded queries (the counters `stage_live` and `stage_width`
of the port's span `lp.ladder`), times 100."""

from benchmark import counters


def read(run):
    found = counters.totals(run, "lp.ladder", ("stage_live", "stage_width"))
    if not found:
        return None
    width = sum(w for _, w in found)
    return 100 * sum(live for live, _ in found) / width if width else None
