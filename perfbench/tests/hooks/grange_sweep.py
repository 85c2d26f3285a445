"""``bin`` for grange_sweep: bin 1 of genome 0 altered where the sweep
returns the histogram (``GRangeEngine.hist_device_stream``)."""

from sylph_tpu_torch.gpu import grange


def bin(patch):  # noqa: A001
    orig = grange.GRangeEngine.hist_device_stream

    def sweep(self, *a, **kw):
        hist, probe, P = orig(self, *a, **kw)
        hist = hist.clone()
        hist[1] += 1
        return hist, probe, P
    patch(grange.GRangeEngine, "hist_device_stream", sweep)
