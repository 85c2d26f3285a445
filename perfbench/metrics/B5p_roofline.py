"""B5' (csrc/join.cu in its count mode, a launch a bucket-regime chunk) as
a share of its roofline: the least time its compares and bytes need over
its profiler time. Nothing where another mode of the same kernel ran in
the traced window."""

from perfbench.bounds.roofline import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "join_kernel", "B5p_bucket_join", "B5p",
                        rivals=("B2_join_codes_compact", "B4_join_codes",
                                "B5_join_counts",
                                "B2b_join_codes_compact_batched",
                                "B4b_join_codes_batched",
                                "B5b_join_counts_batched"))
