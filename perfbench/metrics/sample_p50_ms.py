"""The median, over the measured window's samples, of a sample's time
from its first call to its result on the host."""

import statistics


def read(ctx):
    lat = ctx.latencies_ms
    return statistics.median(lat) if lat else None
