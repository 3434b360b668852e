"""Device milliseconds a query in the port's span `lp.first`
(`exec.bulk.lp_match_stats`): #12's hash and the mask, step 0 of every
probe lane at full width and the accumulators' `cat`, over the device's
stretch's recorded queries."""

from benchmark import spans


def read(run):
    return spans.mean_device_ms(run, "lp.first")
