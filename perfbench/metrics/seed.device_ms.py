"""Device ms a sample that the port's work inside the harness's "seed" span
took (kernels and copies the profiler links to it), over the traced
samples."""

from perfbench.trace import per_sample_ms


def read(ctx):
    return per_sample_ms(ctx, "seed")
