"""``bin`` for merge_join: bin 1 of genome 0 altered where the merge join
returns the histograms (``pipeline.merge_join_hist``)."""

from sylph_tpu_torch.gpu import pipeline


def bin(patch):  # noqa: A001
    orig = pipeline.merge_join_hist

    def join(*a, **kw):
        hist = orig(*a, **kw).clone()
        hist[0, 1] += 1
        return hist
    patch(pipeline, "merge_join_hist", join)
