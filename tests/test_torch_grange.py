"""The port's grange engine (sylph_tpu_torch/gpu/grange.py) against the JAX
package's (sylph_tpu/tpu/grange.py) on the CPU, inputs made by numpy from a
seed: the index layout field by field, one chunk's code stream bit for bit
(fill + compare/compact + repack chain, the JAX kernels in interpret mode),
and the [G, 64] histograms exactly.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sylph_tpu.tpu.grange as jgr
from sylph_tpu.tpu import u64
from sylph_tpu_torch.gpu import _cuda
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


# ---- the stream sweep's static inputs, histogram and shapes ----------------

def _stream_engine(case):
    make, G, kw = _ENGINE_CASES[case]
    kmers, gids, sk, sc = make()
    idx = tgr.build_grange_index(kmers, gids, G, device="cpu", **kw)
    skey = torch.from_numpy(sk.view(np.int64))
    return tgr.GRangeEngine(idx, device="cpu"), skey, torch.from_numpy(
        np.minimum(sc, 63).astype(np.uint8))


@pytest.mark.parametrize("case,grow", [("flat", 1), ("tiled", 1),
                                       ("tiled", 4)])
def test_stream_sweep_on_padded_static_inputs_is_bit_identical(case, grow):
    """The sweep on the sample staged into static buffers longer than it
    (KEY_PAD and 0 tails, as a graph replay reads it) gives the histogram
    and probe of the unpadded sample, bit for bit, also written into a
    reused output buffer."""
    eng, skey, w = _stream_engine(case)
    t = int(skey.shape[0])
    shape = eng.sweep_shape(t)
    Tcap = shape.Tcap * grow
    assert Tcap > t
    keys = torch.full((Tcap,), 7, dtype=torch.int64)
    wb = torch.full((Tcap,), 9, dtype=torch.int32)
    tgr.stage_sample(keys, wb, skey, w)
    assert (keys[t:] == -1).all() and (wb[t:] == 0).all()
    want_h, want_p, P = eng.hist_device_stream(skey, w)
    assert P == shape.P and int(want_p[0]) == 0 and want_h[:-1].sum() > 0
    out = torch.full((eng._GE * 64 + tgr.SENT_BINS,), 5, dtype=torch.int64)
    for _ in range(2):
        got_h, got_p = eng._stream_sweep(shape, keys, wb, out=out)
        assert got_h.data_ptr() == out.data_ptr()
        assert torch.equal(got_h, want_h) and torch.equal(got_p, want_p)


def _codes(kind, n, G, rng):
    nb = G * 64
    if kind == "empty":
        return torch.empty(0, dtype=torch.int32)
    if kind == "all_sent":
        return torch.full((n,), -1, dtype=torch.int32)
    v = rng.integers(0, nb, size=n)
    if kind == "largest":
        v[::7] = nb - 1
    live = {"mostly_sent": 0.02, "largest": 0.5, "mixed": 0.5}[kind]
    v[rng.random(n) >= live] = -1
    return torch.from_numpy(v.astype(np.int32))


@pytest.mark.parametrize("kind,n", [("empty", 0), ("all_sent", 5000),
                                    ("largest", 3000), ("mostly_sent", 9000),
                                    ("mixed", 3 * tgr.SENT_BINS + 17)])
def test_hist_from_codes_matches_bincount(kind, n):
    """The sync-free histogram equals torch.bincount(minlength=G*H+1) of
    the codes with SENT in the last bin, in a new buffer and in a reused
    one."""
    G = 37
    codes = _codes(kind, n, G, np.random.default_rng(n))
    seg = torch.where(codes != -1, codes.to(torch.int64), G * 64)
    want = torch.bincount(seg, minlength=G * 64 + 1)
    got = tgr.hist_from_codes(codes, n_genomes=G)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    out = torch.full((G * 64 + tgr.SENT_BINS,), 3, dtype=torch.int64)
    for _ in range(2):
        assert torch.equal(tgr.hist_from_codes(codes, n_genomes=G, out=out),
                           want)
    assert int(want[-1]) == int((codes == -1).sum())
    if kind == "largest":
        assert int(want[G * 64 - 1]) > 0


def test_sweep_shape_is_the_baked_integers():
    """sweep_shape is (P, CS, capr, repack passes, Tcap) as plan_stream,
    _code_plan and the static buffer's length give them: two t whose
    integers agree share one key, and keys differ where P, CS, capr, a
    repack pass or Tcap differ."""
    eng, _skey, _w = _stream_engine("tiled")
    g = eng.gidx
    shapes = {}
    for t in range(1000, 12000, 37):
        s = eng.sweep_shape(t)
        P, CS, density = eng.plan_stream(t)
        capr, steps = tgr._code_plan(density, g.B, g.CI)
        assert s == (P, CS, capr, steps, tgr._tcap(t))
        assert s.Tcap >= max(t, 1024) and s.Tcap & (s.Tcap - 1) == 0
        shapes.setdefault(s, []).append(t)
    assert any(len(ts) > 1 for ts in shapes.values())
    assert len(shapes) < len(range(1000, 12000, 37)) // 4
    # Tcap alone: the same plan either side of a power of two
    assert any(a.Tcap != b.Tcap and a[:4] == b[:4]
               for a in shapes for b in shapes)
    base = eng.sweep_shape(3000)
    retry = eng.sweep_shape(3000, cs=base.CS + 8)
    assert retry != base and retry._replace(CS=base.CS) == base
    by_plan = {}
    for nm in range(0, 400_000, 500):
        s = eng.sweep_shape(3000, n_matches=nm)
        by_plan.setdefault((s.capr, s.steps), s)
    plans = list(by_plan)
    assert len({c for c, _ in plans}) > 1
    assert any(a[0] == b[0] and a[1] != b[1] for a in plans for b in plans)
    assert len(set(by_plan.values())) == len(plans)


def test_eager_stream_sweep_counts():
    """Off a CUDA device the stream sweep runs eagerly and counts so; no
    graph is captured or replayed."""
    eng, skey, w = _stream_engine("flat")
    assert not eng._graph_ready()
    eng.hist_device_stream(skey, w)
    eng.hist_device_stream(skey, w, cs=16)
    c = eng.counters
    assert c["stream_eager_sweeps"] == 2
    assert c["stream_graph_replays"] == c["stream_graph_captures"] == 0
    assert not eng._graphs


def test_a_capture_records_only_its_own_threads_launches():
    """Inside recording_launches the thread's launches count in the
    capture's record, not in LAUNCHES; another thread's launches at the
    same time count in LAUNCHES as usual; count_launches adds a record."""
    before = dict(_cuda.LAUNCHES)

    def other():
        for _ in range(5):
            _cuda.count_launch("B1_fill")
    try:
        with _cuda.recording_launches() as held:
            _cuda.count_launch("B1_fill")
            _cuda.count_launch("B3_repack")
            th = threading.Thread(target=other)
            th.start()
            th.join()
            _cuda.count_launch("B3_repack")
        _cuda.count_launch("B3_repack")
        delta = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                 if v != before[k]}
        assert held == {"B1_fill": 1, "B3_repack": 2}
        assert delta == {"B1_fill": 5, "B3_repack": 1}
        _cuda.count_launches(held)
        assert _cuda.LAUNCHES["B1_fill"] - before["B1_fill"] == 6
        assert _cuda.LAUNCHES["B3_repack"] - before["B3_repack"] == 3
        assert getattr(_cuda._RECORDING, "counts", None) is None
    finally:
        with _cuda._COUNT_LOCK:
            _cuda.LAUNCHES.update(before)
