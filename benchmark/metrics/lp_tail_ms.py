"""Device milliseconds a query in the port's span `lp.tail`
(`exec.bulk.lp_match_stats`): the tail's probe steps at the ladder's last
width and their scatter, over the device's stretch's recorded queries."""

from benchmark import spans


def read(run):
    return spans.mean_device_ms(run, "lp.tail")
