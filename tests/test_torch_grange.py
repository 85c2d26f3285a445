"""The port's grange engine (sylph_tpu_torch/gpu/grange.py) against the JAX
package's (sylph_tpu/tpu/grange.py) on the CPU, inputs made by numpy from a
seed: the index layout field by field, one chunk's code stream bit for bit
(fill + compare/compact + repack chain, the JAX kernels in interpret mode),
and the [G, 64] histograms exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sylph_tpu.tpu.grange as jgr
from sylph_tpu.tpu import u64
from sylph_tpu_torch.gpu import grange as tgr
from sylph_tpu_torch.gpu.keys import from_pair_np
from tests.test_grange import _oracle_hists, _world, _zipf_world

torch.set_num_threads(1)

# (world, n_genomes, build kwargs): flat, tiled, forced spill, heavy runs,
# heavy runs whose marker slots spill, and the auto layout pick (tiled)
_INDEX_CASES = {
    "flat": (lambda: _world(0, m=60_000), 50,
             dict(chunk_slots=1 << 14, target_mean=64)),
    "tiled": (lambda: _world(1, m=60_000, dup_frac=0.3), 50,
              dict(chunk_slots=1 << 14, target_mean=512, nt=4)),
    "spill": (lambda: _world(3, m=50_000, dup_frac=0.4), 50,
              dict(chunk_slots=1 << 14, target_mean=256, ci_cap=8)),
    "heavy": (lambda: _zipf_world(1, n_unique=12_000), 60,
              dict(chunk_slots=1 << 15, target_mean=512, nt=4,
                   heavy_run=16)),
    "heavy_spill": (lambda: _zipf_world(5, n_unique=8_000, alpha=1.2,
                                        dmax=50), 60,
                    dict(chunk_slots=1 << 13, target_mean=1024, ci_cap=8,
                         heavy_run=8, nt=1)),
    "auto": (lambda: _world(0, m=1 << 17, dup_frac=0.2), 50,
             dict(chunk_slots=1 << 17)),
}


def _assert_same_index(port: tgr.GRangeIndex, ref: jgr.GRangeIndex):
    assert len(port.chunk_keys) == len(ref.chunk_hi)
    for k, g, rh, rl, rg in zip(port.chunk_keys, port.chunk_gid,
                                ref.chunk_hi, ref.chunk_lo, ref.chunk_gid):
        assert k.dtype == torch.int64 and g.dtype == torch.int32
        np.testing.assert_array_equal(k.numpy(), from_pair_np(rh, rl))
        np.testing.assert_array_equal(g.numpy(), rg)
    for f in ("bases", "edges_u64", "spill_kmers", "spill_gids",
              "heavy_gids", "heavy_ptr"):
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("width", "B", "CI", "m", "n_genomes", "nt", "ov", "tile",
              "subwidth", "n_heavy", "g_eff"):
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("case", sorted(_INDEX_CASES))
def test_build_grange_index_matches_jax(case):
    make, G, kw = _INDEX_CASES[case]
    kmers, gids = make()[:2]
    ref = jgr.build_grange_index(kmers, gids, G, **kw)
    port = tgr.build_grange_index(kmers, gids, G, device="cpu", **kw)
    _assert_same_index(port, ref)
    if case == "tiled" or case == "auto":
        assert port.nt == 4 and port.ov > 0
    if "spill" in case:
        assert port.spill_kmers.size > 0
    if "heavy" in case:
        assert port.n_heavy > 0


def test_index_from_numpy_matches_jax_index():
    make, G, kw = _INDEX_CASES["heavy"]
    kmers, gids = make()[:2]
    ref = jgr.build_grange_index(kmers, gids, G, **kw)
    _assert_same_index(tgr.index_from_numpy(ref._asdict()), ref)


def test_build_keeps_caller_arrays():
    """Heavy-run markers are written into the sorted copy, never into the
    caller's (kmer, gid) arrays."""
    kmers, gids = _zipf_world(9, n_unique=5_000)[:2]
    keep_k, keep_g = kmers.copy(), gids.copy()
    idx = tgr.build_grange_index(kmers, gids, 60, chunk_slots=1 << 14,
                                 heavy_run=8, device="cpu")
    assert idx.n_heavy > 0
    np.testing.assert_array_equal(kmers, keep_k)
    np.testing.assert_array_equal(gids, keep_g)


def test_build_defaults_to_cuda(monkeypatch):
    """Without ``device`` the build sorts on the card; with no GPU it
    raises instead of sorting on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kmers, gids = _world(0, m=1_000)[:2]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tgr.build_grange_index(kmers, gids, 50, chunk_slots=1 << 10)


@pytest.mark.parametrize("nt", [1, 4])
def test_chunk_codes_stream_bit_identical(nt, monkeypatch):
    """One chunk through the whole per-chunk pipeline — fill, compare +
    code emission + column compaction, the column-major flattening and
    the repack chain — gives the JAX stream bit for bit (the JAX fill,
    compact and repack kernels in interpret mode)."""
    monkeypatch.setattr(jgr, "_CODES_INTERPRET", True)
    monkeypatch.setattr(jgr, "_FILL_INTERPRET", True)
    kmers, gids, sk, sc = _world(2, m=120_000, t=2_000)
    gidx = jgr.build_grange_index(kmers, gids, 50, chunk_slots=1 << 16,
                                  target_mean=64, nt=nt)
    eng = tgr.GRangeEngine(tgr.index_from_numpy(gidx._asdict()),
                           device="cpu")
    slices, P, CS, density = eng.plan(sk)
    G, B, TB = gidx.g_eff, gidx.B, 64
    capr = jgr._capr(density, TB)
    assert capr < TB, "the column-compacting branch (B2) is under test"
    assert jgr._fill_supported(B * nt, CS)
    s, e = slices[0]
    hi, lo = u64.from_u64_np(sk)
    w8 = np.minimum(sc, 63).astype(np.uint8)
    ph, pl_, pw = jgr._pad_slice(hi, lo, w8, s, e, P)
    want = jgr._chunk_codes(
        jnp.asarray(gidx.chunk_hi[0]), jnp.asarray(gidx.chunk_lo[0]),
        jnp.asarray(gidx.chunk_gid[0]), jnp.asarray(ph), jnp.asarray(pl_),
        jnp.asarray(pw), jnp.uint32(gidx.bases[0]), width=gidx.width, B=B,
        CS=CS, n_genomes=G, density=density, use_pallas=False,
        use_fill=True, fused=True, kcompact=True, nt=gidx.nt,
        subwidth=gidx.subwidth, ov=gidx.ov)
    skey, sw = eng.upload_sample(sk, sc)
    got = tgr._chunk_codes(
        eng.gidx.chunk_keys[0], eng.gidx.chunk_gid[0],
        *tgr._pad_slice(skey, sw, s, e, P), int(gidx.bases[0]),
        width=gidx.width, B=B, CS=CS, n_genomes=G, density=density,
        nt=gidx.nt, subwidth=gidx.subwidth, ov=gidx.ov)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(want[0]).view(np.int32))
    for g, w in zip(got[1:], want[1:]):
        assert int(g) == int(w)
    assert int(got[1]) == int(got[2]) > 0 and int(got[3]) == 0
    # the repack chain ran: the stream is shorter than the compacted block
    assert got[0].numel() < B // TB * capr * gidx.CI


_ENGINE_CASES = {
    "flat": (lambda: _world(10, m=60_000, t=3_000), 50,
             dict(chunk_slots=1 << 14, target_mean=64)),
    "tiled": (lambda: _world(11, m=60_000, t=3_000, dup_frac=0.3), 50,
              dict(chunk_slots=1 << 14, target_mean=512, nt=4)),
    "spill": (lambda: _world(12, m=40_000, t=3_000, dup_frac=0.4), 50,
              dict(chunk_slots=1 << 14, target_mean=256, ci_cap=8)),
    "heavy": (lambda: _zipf_world(13, n_unique=10_000, t=3_000), 60,
              dict(chunk_slots=1 << 15, target_mean=512, nt=4,
                   heavy_run=8)),
}


@pytest.mark.parametrize("case", sorted(_ENGINE_CASES))
def test_engine_hists_match_jax_and_oracle(case, monkeypatch):
    """GRangeEngine(device="cpu").hists == the JAX engine with its fill,
    fused-code and repack kernels in interpret mode == the oracle."""
    make, G, kw = _ENGINE_CASES[case]
    kmers, gids, sk, sc = make()
    ref_idx = jgr.build_grange_index(kmers, gids, G, **kw)
    monkeypatch.setattr(jgr, "_CODES_INTERPRET", True)
    monkeypatch.setattr(jgr, "_FILL_INTERPRET", True)
    want = jgr.GRangeEngine(ref_idx,
                            devices=[jax.devices()[0]]).hists(sk, sc)
    eng = tgr.GRangeEngine(tgr.index_from_numpy(ref_idx._asdict()),
                           device="cpu")
    got = eng.hists(sk, sc)
    assert got.dtype == np.int64 and got.shape == (G, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle_hists(kmers, gids, G, sk,
                                                     sc))
    assert got.sum() > 0


def test_engine_lossless_redo_is_exact(monkeypatch):
    """A column capacity far below the live codes of a dense sample makes
    every chunk fail its conservation check (n_live != n_comp); the
    lossless redo (flat fill + the B5 count grid) must still give the
    exact histogram."""
    kmers, gids, _, _ = _world(4, m=60_000)
    rng = np.random.default_rng(4)
    sk = np.unique(kmers[::2])
    sc = rng.integers(1, 80, size=sk.size).astype(np.uint32)
    ref_idx = jgr.build_grange_index(kmers, gids, 50, chunk_slots=1 << 14,
                                     target_mean=64)
    eng = tgr.GRangeEngine(tgr.index_from_numpy(ref_idx._asdict()),
                           device="cpu")
    redo = []
    lossless = tgr._chunk_hist_lossless
    monkeypatch.setattr(tgr, "_capr", lambda density, TB: 8)
    monkeypatch.setattr(tgr, "_chunk_hist_lossless",
                        lambda *a, **kw: redo.append(1) or lossless(*a,
                                                                    **kw))
    got = eng.hists(sk, sc)
    assert len(redo) == len(ref_idx.chunk_hi)
    np.testing.assert_array_equal(got, _oracle_hists(kmers, gids, 50, sk,
                                                     sc))
    np.testing.assert_array_equal(got, jgr.GRangeEngine(ref_idx).hists(sk,
                                                                      sc))


def test_engine_mask_fn_path_matches_full_hist():
    """hists(mask_fn=...) returns the [G] mask of the device histogram
    (no [G, 64] fetch) — the same mask as on the full histogram."""
    make, G, kw = _ENGINE_CASES["flat"]
    kmers, gids, sk, sc = make()
    idx = tgr.build_grange_index(kmers, gids, G, device="cpu", **kw)
    eng = tgr.GRangeEngine(idx, device="cpu")
    full = eng.hists(sk, sc)

    def mask_fn(h):
        return h.view(G, 64)[:, 3:].sum(dim=1) > 0

    got = eng.hists(sk, sc, mask_fn=mask_fn)
    assert got.shape == (G,) and got.dtype == bool
    np.testing.assert_array_equal(got, full[:, 3:].sum(axis=1) > 0)


def test_bounded_residency_matches_resident():
    make, G, kw = _ENGINE_CASES["flat"]
    kmers, gids, sk, sc = make()
    idx = tgr.build_grange_index(kmers, gids, G, device="cpu", **kw)
    full = tgr.GRangeEngine(idx, device="cpu").hists(sk, sc)
    part = tgr.GRangeEngine(idx, device="cpu",
                            max_resident_chunks=1).hists(sk, sc)
    np.testing.assert_array_equal(full, part)


def test_empty_sample():
    make, G, kw = _ENGINE_CASES["flat"]
    kmers, gids = make()[:2]
    idx = tgr.build_grange_index(kmers, gids, G, device="cpu", **kw)
    got = tgr.GRangeEngine(idx, device="cpu").hists(
        np.empty(0, np.uint64), np.empty(0, np.uint32))
    assert got.shape == (G, 64) and got.sum() == 0


# ---- the streamed device-resident sample ------------------------------------

def _stream_view(sk, sc, seed, device="cpu"):
    """Push the sample in a shuffled (unsorted, first-insertion-like) order
    in uneven segments; finalize into a DeviceSampleView."""
    from sylph_tpu_torch.engine.device_sketch import DeviceSampleStream
    rng = np.random.default_rng(seed)
    perm = rng.permutation(sk.size)
    uk, uc = sk[perm], sc[perm]
    st = DeviceSampleStream(torch.device(device))
    pos = 0
    while pos < uk.size:
        step = int(rng.integers(1, uk.size // 3 + 2))
        st.push(uk[pos:pos + step])
        pos += step
    view = st.finalize(uk, uc)
    assert view is not None and view.n == sk.size
    return view


def _view_world(weights):
    """tests/test_grange.py's device-view worlds: dense weights
    (test_grange_device_view_matches_host_upload, seed 7) or counts almost
    all 1 (test_grange_device_view_sparse_weights, seed 12)."""
    if weights == "dense":
        return _world(7)
    kmers, gids, sk, sc = _world(12)
    sc = np.ones_like(sc)
    rng = np.random.default_rng(4)
    hot = rng.choice(sk.size, size=max(3, sk.size // 200), replace=False)
    sc[hot] = rng.integers(2, 90, hot.size)
    return kmers, gids, sk, sc


def _mask_fns(gids, G):
    from sylph_tpu.engine.prefilter import \
        candidate_mask_device as j_mask_device
    from sylph_tpu_torch.engine.prefilter import candidate_mask_device
    n_kmers = np.bincount(gids, minlength=G).astype(np.int32)
    kw = dict(k=31, min_ani=0.5, min_number_kmers=50.0,
              min_count_correct=3.0, no_adj=False)
    nk_t = torch.from_numpy(n_kmers)
    return (lambda h: candidate_mask_device(h, nk_t, **kw),
            lambda h: j_mask_device(h, jnp.asarray(n_kmers), **kw))


@pytest.mark.parametrize("weights", ["dense", "sparse"])
def test_device_view_matches_host_and_jax(weights):
    """hists(device_view=) == hists(host table) == the JAX engine; the
    one-fetch stream sweep gives the JAX stream sweep's mask and match
    total, with and without a match-count hint."""
    from sylph_tpu.engine.device_sketch import \
        DeviceSampleStream as JStream
    kmers, gids, sk, sc = _view_world(weights)
    G = 50
    ref_idx = jgr.build_grange_index(kmers, gids, G, chunk_slots=1 << 16,
                                     target_mean=128)
    eng = tgr.GRangeEngine(tgr.index_from_numpy(ref_idx._asdict()),
                           device="cpu")
    host = eng.hists(sk, sc)
    np.testing.assert_array_equal(host, _oracle_hists(kmers, gids, G, sk,
                                                      sc))
    view = _stream_view(sk, sc, seed=3)
    assert view.w_spec[0] == weights
    got = eng.hists(None, None, device_view=view,
                    table_fn=lambda: (sk, sc))
    np.testing.assert_array_equal(got, host)
    assert eng.counters["device_view_sorts"] == 1

    mask_fn, j_mask_fn = _mask_fns(gids, G)
    per_chunk = eng.hists(None, None, mask_fn=mask_fn, device_view=view,
                          table_fn=lambda: (sk, sc))
    assert per_chunk.ndim == 1 and per_chunk.dtype == bool
    ms = eng.candidate_mask_stream(view, mask_fn)
    assert ms is not None and eng.counters["mask_stream_masks"] == 1
    np.testing.assert_array_equal(ms[0], per_chunk)

    dev = jax.devices()[0]
    jeng = jgr.GRangeEngine(ref_idx, devices=[dev])
    jst = JStream(dev)
    perm = np.random.default_rng(3).permutation(sk.size)
    jst.push(sk[perm])
    jview = jst.finalize(sk[perm], sc[perm])
    jms = jeng.candidate_mask_stream(jview, j_mask_fn)
    assert jms is not None
    np.testing.assert_array_equal(ms[0], jms[0])
    assert ms[1] == jms[1] > 0
    grid = host - (eng._spill_hist(sk, sc) if ref_idx.spill_kmers.size
                   else 0)
    assert ms[1] == int(grid.sum())
    hinted = eng.candidate_mask_stream(view, mask_fn,
                                       n_matches=int(ms[1] * 1.5) + 8)
    assert hinted is not None
    np.testing.assert_array_equal(hinted[0], ms[0])
    assert hinted[1] == ms[1]


def test_mask_stream_probe_rejects_short_slices(monkeypatch):
    """A slice length below the longest chunk slice fails the probe (the
    caller then takes the per-chunk path) instead of cutting the slice."""
    kmers, gids, sk, sc = _view_world("dense")
    G = 50
    idx = tgr.build_grange_index(kmers, gids, G, chunk_slots=1 << 16,
                                 target_mean=128, device="cpu")
    eng = tgr.GRangeEngine(idx, device="cpu")
    view = _stream_view(sk, sc, seed=5)
    mask_fn, _ = _mask_fns(gids, G)
    assert eng.candidate_mask_stream(view, mask_fn) is not None
    monkeypatch.setattr(tgr, "_quantize_p", lambda want, t=None: 1024)
    skey, w = eng._sorted_device_sample(view)
    _hist, probe, P = eng.hist_device_stream(skey, w)
    assert P == 1024 < int(probe[1])
    assert eng.candidate_mask_stream(view, mask_fn) is None
    assert eng.counters["mask_stream_rejected"] == 1


def test_sample_stream_out_of_sync_raises():
    from sylph_tpu_torch.engine.device_sketch import DeviceSampleStream
    st = DeviceSampleStream(torch.device("cpu"))
    st.push(np.arange(5, dtype=np.uint64))
    with pytest.raises(RuntimeError, match="out of sync"):
        st.finalize(np.arange(6, dtype=np.uint64), np.ones(6, np.uint32))
    assert not st._worker.is_alive()
