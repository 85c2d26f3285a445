"""The bucket regime's launch work (bounds/bucket.py) on the port's own
layout and fill, against the tensor forms of chip_smoke.py's B1 and B5'
bounds (arith.py's ``_join_bytes`` and ``_live_compares`` over the grids
the launches take), and the driver's retry."""

import numpy as np
import pytest
import torch
from sylph_tpu_torch.gpu import bucket_join as bj
from sylph_tpu_torch.gpu.bucket_fill import bucket_fill

from perfbench.bounds import arith, bucket

C = 200
THR = ((1 << 64) - 1) // C


def _chunk(seed, n_live, n_slots, t):
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, THR, size=n_live,
                                         dtype=np.uint64).view(np.int64))
    smp = np.unique(rng.integers(0, THR, size=t, dtype=np.uint64))
    return keys, torch.from_numpy(smp.view(np.int64))


@pytest.mark.parametrize("seed,n_live,n_slots,t", [
    (0, 4096, 4096, 3000), (1, 3000, 4096, 500), (2, 8192, 8192, 20000)])
def test_launches_equal_the_tensor_forms(seed, n_live, n_slots, t):
    keys, skey = _chunk(seed, n_live, n_slots, t)
    bidx = bj.build_bucketed_index(keys.numpy(), C, n_slots=n_slots)
    lay = bucket.Layout(bidx.n_buckets, bidx.key.shape[1], bidx.width,
                        (bidx.key != -1).sum(1))
    CS = 8 if seed == 2 else bj.sample_cs(skey.numel(), lay.B)
    sw = torch.ones(skey.shape, dtype=torch.int32)
    dk, dw = bucket_fill(skey, sw, 0, width=lay.width, B=lay.B, CS=CS)
    live = bucket.lanes(skey, lay, CS)
    assert torch.equal(live, (dw > 0).sum(1))
    assert bucket.fill_launch(skey.numel(), lay, CS) == (
        int((sw > 0).sum()) * 12 + lay.B * CS * 12, 0)
    nbytes, clocks = bucket.join_launch(lay, live, CS)
    assert nbytes == arith._join_bytes(bidx.key, dw, lay.B * lay.CI * 4)
    assert clocks == arith._live_compares(bidx.key, dw) * \
        arith.COMPARE_CLOCKS


def test_a_failed_probe_is_run_again_inside_the_window(tmp_path, monkeypatch):
    """With the engine's sample capacity forced to 8 lanes, every sample's
    fills drop entries; the driver runs each again at doubled capacities
    until the probe reads 0, and the cell comes out correct."""
    from perfbench.tests.test_perfbench_run import _run
    monkeypatch.setattr(bj.BucketEngine, "cs", lambda self, t: 8)
    orig, capacities = bj.BucketEngine.hist_device_stream, []

    def spy(self, *a, **kw):
        capacities.append(kw.get("cs"))
        return orig(self, *a, **kw)
    monkeypatch.setattr(bj.BucketEngine, "hist_device_stream", spy)
    rc, line = _run(tmp_path, "uhgg_v2_bucket.shallow", trace=1)
    assert rc == 0 and line["correct"] is True
    assert capacities.count(16) == capacities.count(None) >= \
        line["attempted"]
    assert 32 in capacities
