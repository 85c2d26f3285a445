"""B1 (csrc/fill.cu, a launch a bucket-regime chunk, nt = 1 over the whole
hash range) as a share of its roofline: the least time its bytes need over
its profiler time."""

from perfbench.bounds.roofline import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "fill_cells", "B1_fill", "B1")
