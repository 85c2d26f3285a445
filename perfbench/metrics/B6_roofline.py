"""B6 (csrc/seed_pack.cu's row kernel, a launch a read batch) as a share
of its roofline: the least time its batches' windows and bytes need over
its profiler time."""

from perfbench.bounds.roofline import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "seed_pack_rows", "B6_seed_pack", "B6",
                        rivals=("B10_seed_compact",))
