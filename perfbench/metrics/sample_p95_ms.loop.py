"""The 95th percentile, over the measured window's samples, of a sample's
time from its first call to its result on the host (numpy's linear
interpolation)."""

import numpy as np


def read(ctx):
    lat = ctx.latencies_ms
    return float(np.percentile(lat, 95)) if lat else None
