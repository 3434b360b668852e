"""Device milliseconds a query in the port's span `lp.ladder`
(`exec.bulk.lp_match_stats`): the compaction ladder's stages, each #9 over
the surviving lanes, a gather of their keys, one probe step and its
scatter, over the device's stretch's recorded queries."""

from benchmark import spans


def read(run):
    return spans.mean_device_ms(run, "lp.ladder")
