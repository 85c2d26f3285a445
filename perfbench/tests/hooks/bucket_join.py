"""``bin`` for bucket_join: bin 1 of genome 0 altered where the bucket
regime's engine returns the histograms
(``BucketEngine.hist_device_stream``)."""

from sylph_tpu_torch.gpu import bucket_join


def bin(patch):  # noqa: A001
    orig = bucket_join.BucketEngine.hist_device_stream

    def hist(self, *a, **kw):
        h, probe = orig(self, *a, **kw)
        h = h.clone()
        h[0, 1] += 1
        return h, probe
    patch(bucket_join.BucketEngine, "hist_device_stream", hist)
