"""Kernel launches a sample of the measured window, by the port's own
counters (gpu/_cuda.py::LAUNCHES)."""


def read(ctx):
    n = sum(ctx.launches.values())
    return n / ctx.window_samples if n and ctx.window_samples else None
