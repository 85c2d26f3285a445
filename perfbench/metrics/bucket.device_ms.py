"""Device ms a sample that the port's work inside the harness's "bucket"
span took (the bucket regime's fold, fills, joins and binning: the
kernels and copies the profiler links to it), over the traced samples."""

from perfbench.trace import per_sample_ms


def read(ctx):
    return per_sample_ms(ctx, "bucket")
