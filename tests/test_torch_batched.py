"""Multi-sample cohorts in the port against the JAX package, on the CPU.

- The batched compare kernels' plain versions (B2b, B4b, B5b in
  sylph_tpu_torch/gpu/bucket_join.py) against the JAX package's batched
  Pallas kernels in interpret mode (B5b against its XLA form), bit for bit,
  and at S = 1 against B2, B4 and B5.
- The batched grange sweep (gpu/grange.py: _chunk_codes_batched,
  hist_device_stream_batched, hists_batched) against the JAX engine's and
  against per-sample sweeps; the batched merge join against per-sample
  joins and the JAX vmapped join.
- DeviceContainment.prefetch per regime, and the prefilter of a prefetched
  grange sample: no second sweep, the JAX prefilter's candidates.
- The runner's cohort loop: input order, skipped samples, depth.
Every comparison is exact; inputs are made by numpy from seeds.
"""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sylph_tpu.tpu.grange as jgr
from sylph_tpu.core.types import GenomeSketch as JGenome
from sylph_tpu.core.types import SequencesSketch as JSample
from sylph_tpu.engine.device_exec import _merge_join_batched_jit
from sylph_tpu.engine.prefilter import prefilter_candidates as j_prefilter
from sylph_tpu.engine.runner import ContainOptions as JOptions
from sylph_tpu.tpu import u64
from sylph_tpu.tpu.bucket_join import _sample_to_buckets
from sylph_tpu_torch.core.types import GenomeSketch, SequencesSketch
from sylph_tpu_torch.engine import device_exec, runner
from sylph_tpu_torch.engine.device_exec import DeviceContainment
from sylph_tpu_torch.engine.prefilter import prefilter_candidates
from sylph_tpu_torch.gpu import bucket_join as bj
from sylph_tpu_torch.gpu import grange as tgr
from sylph_tpu_torch.gpu.containment import (merge_join_counts,
                                             merge_join_counts_batched)
from sylph_tpu_torch.gpu.keys import from_pair_np
from tests.test_fused_codes import _chunk_world, _tiled_world
from tests.test_grange import _oracle_hists, _world
from tests.test_torch_grange import _ENGINE_CASES, _stream_view

torch.set_num_threads(1)
SENT = np.uint32(0xFFFFFFFF)
H = 64


def _keys(hi, lo) -> torch.Tensor:
    return torch.from_numpy(from_pair_np(np.asarray(hi), np.asarray(lo)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _i32(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


# ---- B2b / B4b / B5b: the batched compare ----------------------------------

def _slice_for(ihi, ilo, base, width, B, P, seed, n):
    """A sorted sample slice of P lanes against the index grids (half its
    entries copy index slots), SENT tail: _chunk_world's sampling."""
    rng = np.random.default_rng(seed)
    ihi, ilo = np.asarray(ihi).reshape(-1), np.asarray(ilo).reshape(-1)
    pick = rng.integers(0, ihi.size, size=n // 2)
    shi = np.concatenate([ihi[pick], rng.integers(
        base, base + B * width, size=n - n // 2, dtype=np.uint32)])
    slo = np.concatenate([ilo[pick], rng.integers(
        0, 2**32, size=n - n // 2, dtype=np.uint32)])
    keep = shi != SENT
    shi, slo = shi[keep], slo[keep]
    order = np.lexsort((slo, shi))
    ph = np.full(P, SENT, np.uint32)
    pl_ = np.full(P, SENT, np.uint32)
    pw = np.zeros(P, np.int32)
    k = order.size
    ph[:k], pl_[:k] = shi[order], slo[order]
    pw[:k] = rng.integers(1, 80, size=k)
    return ph, pl_, pw


def _batched_cells(layout, S, seed):
    """An index chunk and S samples' [S, B, LW] cell grids (the JAX fill):
    _chunk_world (flat) or _tiled_world (nt = 4) and S - 1 more samples
    against the same chunk."""
    if layout == "flat":
        ihi, ilo, gid, sh, sl, sw, base, width, B, CS, G = _chunk_world(
            seed)
        nt, subw, tile, P, n = 1, 0, 0, 512, 300
    else:
        (ihi, ilo, gid, sh, sl, sw, base, width, B, CS, G, nt, subw,
         ov) = _tiled_world(seed)
        tile, P, n = (ihi.shape[1] - ov) // nt, 256, 220
    slices = [(sh, sl, sw)] + [
        _slice_for(ihi, ilo, int(base), width, B, P, 100 * seed + s, n)
        for s in range(1, S)]
    LW = nt * CS
    cells = [_sample_to_buckets(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(c), width=width, B=B, CS=CS,
                                base=int(base), nt=nt, subwidth=subw)
             for a, b, c in slices]
    dh, dl, dw = (jnp.stack([c[x].reshape(B, LW) for c in cells])
                  for x in range(3))
    return ihi, ilo, gid, dh, dl, dw, G, nt, tile


def _port_args(ihi, ilo, gid, dh, dl, dw):
    return _keys(ihi, ilo), _t(gid), _keys(dh, dl), _t(dw)


@pytest.mark.parametrize("layout,S,seed,capr", [
    ("flat", 1, 0, 8), ("flat", 3, 5, 16), ("tiled", 1, 1, 8),
    ("tiled", 3, 2, 16)])
def test_join_codes_compact_batched_matches_pallas(layout, S, seed, capr,
                                                   monkeypatch):
    monkeypatch.setattr(jgr, "_CODES_INTERPRET", True)
    ihi, ilo, gid, dh, dl, dw, G, nt, tile = _batched_cells(layout, S, seed)
    want, want_nl = jgr._codes_from_buckets_compact_batched(
        ihi, ilo, gid, dh, dl, dw, G=G, H=H, CAPR=capr, nt=nt, tile=tile)
    got, got_nl = bj.join_codes_compact_batched(
        *_port_args(ihi, ilo, gid, dh, dl, dw), G=G, CAPR=capr, nt=nt,
        tile=tile)
    B, CI = ihi.shape
    assert got.shape == (S, B // bj.block_rows(B) * capr, CI)
    np.testing.assert_array_equal(got.numpy(), _i32(want))
    assert int(got_nl) == int(want_nl) > 0
    # every sample's codes carry its tag s*G*64
    for s in range(S):
        live = got[s][got[s] != -1]
        assert live.numel() and bool(((live // (G * H)) == s).all())


def test_join_codes_compact_batched_overflow_detected(monkeypatch):
    """Columns deeper than CAPR in two samples: n_live counts every live
    slot of the batch while each sample keeps CAPR rows per column, as in
    the Pallas kernel."""
    monkeypatch.setattr(jgr, "_CODES_INTERPRET", True)
    B, CI, G, width = 8, 16, 3, 32
    ihi = np.repeat((100 + np.arange(B) * width).astype(np.uint32)[:, None],
                    CI, axis=1)
    ilo = np.full((B, CI), 7, np.uint32)
    gid = np.ones((B, CI), np.int32)
    cells = []
    for wt in (1, 70):
        sh = np.full(64, SENT, np.uint32)
        sl = np.full(64, SENT, np.uint32)
        sw = np.zeros(64, np.int32)
        sh[:B], sl[:B], sw[:B] = ihi[:, 0], 7, wt
        cells.append(_sample_to_buckets(
            jnp.asarray(sh), jnp.asarray(sl), jnp.asarray(sw), width=width,
            B=B, CS=4, base=100))
    dh, dl, dw = (jnp.stack([c[x] for c in cells]) for x in range(3))
    args = (jnp.asarray(ihi), jnp.asarray(ilo), jnp.asarray(gid), dh, dl, dw)
    want, want_nl = jgr._codes_from_buckets_compact_batched(*args, G=G, H=H,
                                                            CAPR=4)
    got, got_nl = bj.join_codes_compact_batched(*_port_args(*args), G=G,
                                                CAPR=4)
    np.testing.assert_array_equal(got.numpy(), _i32(want))
    assert int(got_nl) == int(want_nl) == 2 * B * CI
    assert int((got != -1).sum()) == B * CI          # the visible drop


@pytest.mark.parametrize("layout,S,seed", [
    ("flat", 1, 1), ("flat", 3, 4), ("tiled", 1, 3), ("tiled", 3, 0)])
def test_join_codes_batched_matches_pallas(layout, S, seed, monkeypatch):
    monkeypatch.setattr(jgr, "_CODES_INTERPRET", True)
    ihi, ilo, gid, dh, dl, dw, G, nt, tile = _batched_cells(layout, S, seed)
    want = jgr._codes_from_buckets_batched(ihi, ilo, gid, dh, dl, dw, G=G,
                                           H=H, nt=nt, tile=tile)
    got = bj.join_codes_batched(*_port_args(ihi, ilo, gid, dh, dl, dw), G=G,
                                nt=nt, tile=tile)
    np.testing.assert_array_equal(got.numpy(), _i32(want))
    assert int((got != -1).sum()) > 0


@pytest.mark.parametrize("layout,seed", [("flat", 2), ("tiled", 5)])
def test_join_counts_batched_matches_xla(layout, seed):
    ihi, ilo, gid, dh, dl, dw, G, nt, tile = _batched_cells(layout, 3, seed)
    want = jgr._grid_from_buckets_batched(ihi, ilo, dh, dl, dw,
                                          use_pallas=False, nt=nt,
                                          tile=tile)
    got = bj.join_counts_batched(_keys(ihi, ilo), _keys(dh, dl), _t(dw),
                                 nt=nt, tile=tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_batched_rows_are_the_single_sample_kernels(layout):
    """At S = 1 each batched form gives B2's, B4's and B5's output bit for
    bit (tag 0); at S = 3 row s is the single-sample output of sample s
    with s*G*64 added to its live codes."""
    ihi, ilo, gid, dh, dl, dw, G, nt, tile = _batched_cells(layout, 3, 7)
    ikey, gidt, dk, dwt = _port_args(ihi, ilo, gid, dh, dl, dw)
    kw = dict(nt=nt, tile=tile)
    for s in range(3):
        one = (dk[s:s + 1], dwt[s:s + 1])
        single = bj.join_codes_compact(ikey, gidt, dk[s], dwt[s], G=G,
                                       CAPR=8, **kw)
        batched = bj.join_codes_compact_batched(ikey, gidt, *one, G=G,
                                                CAPR=8, **kw)
        assert torch.equal(batched[0][0], single[0])
        assert int(batched[1]) == int(single[1])
        assert torch.equal(bj.join_codes_batched(ikey, gidt, *one, G=G,
                                                 **kw)[0],
                           bj.join_codes(ikey, gidt, dk[s], dwt[s], G=G,
                                         **kw))
        assert torch.equal(bj.join_counts_batched(ikey, *one, **kw)[0],
                           bj.join_counts(ikey, dk[s], dwt[s], **kw))
    codes = bj.join_codes_batched(ikey, gidt, dk, dwt, G=G, **kw)
    for s in range(3):
        single = bj.join_codes(ikey, gidt, dk[s], dwt[s], G=G, **kw)
        want = torch.where(single != -1, single + s * G * H, -1)
        assert torch.equal(codes[s], want)


def test_code_space_bound_raises():
    """Sample-tagged int32 codes with a -1 sentinel: a batch whose tags
    would reach bit 31 is refused (S*G*64 + 1 >= 2^31)."""
    ikey = torch.zeros((64, 8), dtype=torch.int64)
    gid = torch.zeros((64, 8), dtype=torch.int32)
    dk = torch.full((2, 64, 8), -1, dtype=torch.int64)
    dw = torch.zeros((2, 64, 8), dtype=torch.int32)
    G = (1 << 24)                 # 2 * 2^24 * 64 = 2^31
    with pytest.raises(ValueError, match="code space"):
        bj.join_codes_batched(ikey, gid, dk, dw, G=G)
    with pytest.raises(ValueError, match="code space"):
        bj.join_codes_compact_batched(ikey, gid, dk, dw, G=G, CAPR=8)
    bj.join_codes_batched(ikey, gid, dk[:1], dw[:1], G=G)   # S = 1 fits


# ---- the batched grange sweep ----------------------------------------------

def _tables(kmers, seed, sizes, dmax=90):
    """Sorted unique (kmers, counts) tables, half their entries drawn from
    the index; a size of 0 gives an empty table."""
    rng = np.random.default_rng(seed)
    thr = ((1 << 64) - 1) // 20
    out = []
    for n in sizes:
        sk = np.unique(np.concatenate([
            rng.choice(kmers, size=n // 2),
            rng.integers(0, thr, size=n - n // 2, dtype=np.uint64)]))
        out.append((sk, rng.integers(1, dmax, size=sk.size).astype(
            np.uint32)))
    return out


@pytest.mark.parametrize("branch,nt", [("compact", 1), ("compact", 4),
                                       ("full", 1)])
def test_chunk_codes_batched_stream_bit_identical(branch, nt, monkeypatch):
    """Three samples' slices of chunk 0 through the batched per-chunk
    pipeline (S fills, one batched compare, the sample-major column-major
    flattening, one repack chain) give the JAX stream bit for bit, the JAX
    fill, compare and repack kernels in interpret mode; ``full`` forces
    the uncompacted branch (B4b) with a density of 1."""
    monkeypatch.setattr(jgr, "_CODES_INTERPRET", True)
    monkeypatch.setattr(jgr, "_FILL_INTERPRET", True)
    kmers, gids, _, _ = _world(2, m=120_000, t=2_000)
    gidx = jgr.build_grange_index(kmers, gids, 50, chunk_slots=1 << 16,
                                  target_mean=64, nt=nt)
    eng = tgr.GRangeEngine(tgr.index_from_numpy(gidx._asdict()),
                           device="cpu")
    tables = _tables(kmers, 9, (2_000, 700, 1_400))
    n_live = [k.size for k, _ in tables]
    P, CS, density = eng.plan_batched(n_live, 4096)
    if branch == "full":
        density = 1.0
    G, B, TB = gidx.g_eff, gidx.B, 64
    capr = jgr._capr(density, TB)
    assert (capr < TB) == (branch == "compact")
    assert jgr._fill_supported(B * nt, CS, 0)
    jparts, tparts = [], []
    for sk, sc in tables:
        s, e = tgr.slice_sample(eng.gidx, sk)[0]
        hi, lo = u64.from_u64_np(sk)
        jparts.append(jgr._pad_slice(hi, lo, np.minimum(sc, 63).astype(
            np.uint8), s, e, P))
        tparts.append(tgr._pad_slice(*eng.upload_sample(sk, sc), s, e, P))
    want = jgr._chunk_codes_batched(
        jnp.asarray(gidx.chunk_hi[0]), jnp.asarray(gidx.chunk_lo[0]),
        jnp.asarray(gidx.chunk_gid[0]),
        *(jnp.asarray(np.stack([p[x] for p in jparts])) for x in range(3)),
        jnp.uint32(gidx.bases[0]), width=gidx.width, B=B, CS=CS,
        n_genomes=G, density=density, use_pallas=False, use_fill=True,
        fused=True, kcompact=True, nt=gidx.nt, subwidth=gidx.subwidth,
        ov=gidx.ov, cover=0)
    got = tgr._chunk_codes_batched(
        eng.gidx.chunk_keys[0], eng.gidx.chunk_gid[0],
        torch.stack([p[0] for p in tparts]),
        torch.stack([p[1] for p in tparts]), int(gidx.bases[0]),
        width=gidx.width, B=B, CS=CS, n_genomes=G, density=density,
        nt=gidx.nt, subwidth=gidx.subwidth, ov=gidx.ov)
    np.testing.assert_array_equal(got[0].numpy(), _i32(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert int(g) == int(w)
    assert int(got[1]) == int(got[2]) > 0 and int(got[3]) == 0
    # codes of all three samples are in the stream
    tags = set((got[0][got[0] != -1] // (G * H)).tolist())
    assert tags == {0, 1, 2}


def test_hist_device_stream_batched_matches_serial_and_jax():
    """Rows of different live lengths (one empty): the batched sweep ==
    per-sample hist_device_stream == the JAX batched sweep."""
    kmers, gids, _, _ = _world(13, m=150_000, G=30)
    ref = jgr.build_grange_index(kmers, gids, 30, chunk_slots=1 << 15,
                                 target_mean=128)
    eng = tgr.GRangeEngine(tgr.index_from_numpy(ref._asdict()),
                           device="cpu")
    tables = _tables(kmers, 4, (8_000, 4_100, 0, 6_500))
    keys, w, n_live = eng.upload_tables(tables)
    assert keys.shape == (4, 8192) and n_live[2] == 0
    hist, probe, P = eng.hist_device_stream_batched(keys, w, n_live)
    assert int(probe[0]) == 0 and int(probe[1]) <= P
    GH = ref.g_eff * H
    assert hist.shape == (4, GH)
    for s, (sk, sc) in enumerate(tables):
        skey, sw = eng.upload_sample(sk, sc)
        h1, p1, P1 = eng.hist_device_stream(skey, sw)
        assert int(p1[0]) == 0 and int(p1[1]) <= P1
        assert torch.equal(hist[s], h1[:GH]), s
        np.testing.assert_array_equal(
            hist[s].numpy().reshape(-1, H)[:30],
            _oracle_hists(kmers, gids, 30, sk, sc))
    assert int(hist[2].sum()) == 0 and int(hist[0].sum()) > 0
    shi = np.full((4, 8192), SENT, np.uint32)
    slo = np.full((4, 8192), SENT, np.uint32)
    ws = np.zeros((4, 8192), np.int32)
    for s, (sk, sc) in enumerate(tables):
        shi[s, :sk.size], slo[s, :sk.size] = u64.from_u64_np(sk)
        ws[s, :sk.size] = np.minimum(sc, 63)
    jeng = jgr.GRangeEngine(ref, devices=[jax.devices()[0]])
    jh, check = jeng.hist_device_stream_batched(
        jnp.asarray(shi), jnp.asarray(slo), n_live=max(n_live),
        n_unique=max(n_live), w_s=jnp.asarray(ws))
    assert check()
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))


@pytest.mark.parametrize("case", sorted(_ENGINE_CASES))
def test_hists_batched_matches_serial_jax_and_oracle(case):
    """hists_batched on the flat, tiled, spill and heavy worlds, a batch
    with an empty sample: == per-sample hists == the JAX hists_batched ==
    the oracle, through one batched sweep and no per-sample one."""
    make, G, kw = _ENGINE_CASES[case]
    kmers, gids = make()[:2]
    ref = jgr.build_grange_index(kmers, gids, G, **kw)
    eng = tgr.GRangeEngine(tgr.index_from_numpy(ref._asdict()),
                           device="cpu")
    tables = _tables(np.unique(kmers), 21, (3_000, 0, 1_700, 2_400))
    got = eng.hists_batched(tables)
    assert eng.counters["batched_sweeps"] == 1
    assert eng.counters["batched_rejected"] == 0
    assert eng.counters["hists_sweeps"] == 0
    assert got.shape == (4, G, H) and got.dtype == np.int64
    # the JAX package fails on an empty sample when the index has spill
    # (test_empty_sample_with_spill): compare the others with it
    live = [1 if t[0].size else 0 for t in tables]
    want = jgr.GRangeEngine(ref, devices=[jax.devices()[0]]).hists_batched(
        [t for t, x in zip(tables, live) if x])
    np.testing.assert_array_equal(got[np.flatnonzero(live)], want)
    for s, (sk, sc) in enumerate(tables):
        np.testing.assert_array_equal(got[s], eng.hists(sk, sc))
        np.testing.assert_array_equal(got[s], _oracle_hists(kmers, gids, G,
                                                            sk, sc))
    assert got[1].sum() == 0 and got[0].sum() > 0


def test_hists_batched_failed_check_falls_back_exactly(monkeypatch):
    """A batch whose cells are too small (cs = 1) fails its conservation
    check; hists_batched then sweeps each sample on its own and stays
    exact."""
    make, G, kw = _ENGINE_CASES["flat"]
    kmers, gids = make()[:2]
    idx = tgr.build_grange_index(kmers, gids, G, device="cpu", **kw)
    eng = tgr.GRangeEngine(idx, device="cpu")
    tables = _tables(np.unique(kmers), 22, (3_000, 2_000, 2_500))
    keys, w, n_live = eng.upload_tables(tables)
    _hist, probe, _P = eng.hist_device_stream_batched(keys, w, n_live, cs=1)
    assert int(probe[0]) > 0
    monkeypatch.setattr(eng, "hist_device_stream_batched", functools.partial(
        eng.hist_device_stream_batched, cs=1))
    got = eng.hists_batched(tables)
    assert eng.counters["batched_rejected"] == 1
    assert eng.counters["hists_sweeps"] == len(tables)
    for s, (sk, sc) in enumerate(tables):
        np.testing.assert_array_equal(got[s], _oracle_hists(kmers, gids, G,
                                                            sk, sc))


def test_empty_sample_with_spill():
    """An empty sample against an index with spill: the JAX engine raises
    IndexError in its spill probe (sylph_tpu/tpu/grange.py:1489); the
    port's spill probe adds nothing and the histogram is all zero."""
    make, G, kw = _ENGINE_CASES["spill"]
    kmers, gids = make()[:2]
    ref = jgr.build_grange_index(kmers, gids, G, **kw)
    assert ref.spill_kmers.size > 0
    empty = (np.empty(0, np.uint64), np.empty(0, np.uint32))
    with pytest.raises(IndexError):
        jgr.GRangeEngine(ref, devices=[jax.devices()[0]]).hists(*empty)
    eng = tgr.GRangeEngine(tgr.index_from_numpy(ref._asdict()),
                           device="cpu")
    got = eng.hists(*empty)
    assert got.shape == (G, H) and got.sum() == 0
    assert eng.hists_batched([empty, empty]).sum() == 0


# ---- the batched merge join ------------------------------------------------

def test_merge_join_batched_matches_serial_and_jax():
    """tests/test_device_chunking.py::test_prefetch_batched_counts_parity's
    world: [S, T] tables of different live lengths (-1 / SENT tails)
    against one index, == per-sample merge_join_counts == the JAX vmapped
    join."""
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 1 << 48, size=4000, dtype=np.uint64)
    idx = np.concatenate([rng.choice(pool, size=600, replace=False)
                          for _ in range(10)])
    T = 2048
    keys = np.full((3, T), -1, np.int64)
    wts = np.zeros((3, T), np.int32)
    for s, n in enumerate((500, 2048, 1101)):
        skm = np.unique(rng.choice(pool, size=n))
        keys[s, :skm.size] = skm.view(np.int64)
        wts[s, :skm.size] = rng.integers(1, 5, size=skm.size)
    ik = torch.from_numpy(idx.view(np.int64))
    got = merge_join_counts_batched(ik, torch.from_numpy(keys),
                                    torch.from_numpy(wts))
    assert got.shape == (3, idx.size) and got.dtype == torch.int32
    for s in range(3):
        assert torch.equal(got[s], merge_join_counts(
            ik, torch.from_numpy(keys[s]), torch.from_numpy(wts[s])))
    ihi, ilo = u64.from_u64_np(idx)
    shi, slo = u64.from_u64_np(keys.view(np.uint64))
    want = _merge_join_batched_jit()(jnp.asarray(ihi), jnp.asarray(ilo),
                                     jnp.asarray(shi), jnp.asarray(slo),
                                     jnp.asarray(wts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got > 0).sum()) > 1000


# ---- DeviceContainment.prefetch --------------------------------------------

def _genomes(seed, G, per, c=100, pool_size=None):
    rng = np.random.default_rng(seed)
    thr = ((1 << 64) - 1) // c
    pool = rng.integers(0, thr, size=pool_size or G * per,
                        dtype=np.uint64)
    return pool, [GenomeSketch(rng.choice(pool, size=per, replace=False),
                               None, f"g{i}", f"c{i}", c, 31, 1_000_000, 30)
                  for i in range(G)]


def _sample(genomes, picks, seed, n_absent=500, c=100):
    """A sample holding the sketches of ``picks`` at multiplicities 2-7
    and ``n_absent`` absent hashes."""
    rng = np.random.default_rng(seed)
    thr = ((1 << 64) - 1) // c
    km = [genomes[g].genome_kmers for g in picks]
    km.append(rng.integers(0, thr, size=n_absent, dtype=np.uint64))
    km = np.unique(np.concatenate(km))
    return SequencesSketch(km, (1 + rng.poisson(3, size=km.size)).astype(
        np.uint32), c, 31, f"s{seed}", None, False, 150.0)


def test_prefetch_merge_fills_counts_for_a_deep_cohort():
    """A cohort of 18 samples (past the default cap of 16): one batched
    join caches every sample's counts, each equal to a per-sample join."""
    _pool, genomes = _genomes(1, 10, 600)
    samples = [_sample(genomes, [i % 10, (3 * i) % 10], 50 + i, 100 + 37 * i)
               for i in range(18)]
    eng = DeviceContainment(genomes, device="cpu")
    assert eng._grange is None and not eng._use_buckets
    eng.prefetch(samples)
    assert eng.counters["batched_joins"] == 1
    assert all(id(s) in eng._cache for s in samples)
    ref = DeviceContainment(genomes, device="cpu")
    for s in samples:
        np.testing.assert_array_equal(eng._counts(s), ref._counts(s))
    assert eng.counters["batched_joins"] == 1


def test_prefetch_bucket_does_nothing(monkeypatch):
    monkeypatch.setattr(DeviceContainment, "CHUNK", 1 << 12)
    monkeypatch.setattr(DeviceContainment, "BUCKET_MIN", 1000)
    _pool, genomes = _genomes(2, 10, 600)
    samples = [_sample(genomes, [i], 60 + i) for i in range(3)]
    eng = DeviceContainment(genomes, device="cpu")
    assert eng._use_buckets
    eng.prefetch(samples)
    assert not eng._cache and not eng._hists_cache
    assert eng.counters["batched_joins"] == 0


@pytest.fixture(scope="module")
def grange_world():
    """70 genomes (the prefilter runs from 64) and five samples, three of
    them planted with genomes at multiplicities 2-7."""
    pool, genomes = _genomes(3, 70, 1500, c=20, pool_size=60_000)
    samples = [_sample(genomes, picks, 70 + i, c=20) for i, picks in
               enumerate([(1, 9, 33), (9, 50), (4, 61, 62, 69), (2,), ()])]
    return genomes, samples


def _grange_engine(genomes, monkeypatch):
    """The grange engine of ``genomes``, its index cut into 7 chunks of 64
    buckets (at the default 2^25-slot chunks this small index would leave
    most columns empty, and the code streams would fail their capacity
    checks: exact still, through the per-sample path)."""
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    monkeypatch.setattr(device_exec, "build_grange_index", functools.partial(
        tgr.build_grange_index, chunk_slots=1 << 14, target_mean=256))
    eng = DeviceContainment(genomes, device="cpu")
    assert eng._grange is not None
    return eng


def test_prefetch_grange_skips_device_view_samples(grange_world,
                                                   monkeypatch):
    genomes, samples = grange_world
    eng = _grange_engine(genomes, monkeypatch)
    viewed = samples[3:]
    for s in viewed:
        sk, sc = s.sorted_view()
        s._device_view = _stream_view(sk, sc, seed=1)
    try:
        eng.prefetch(samples)
    finally:
        for s in viewed:
            s._device_view = None
    c = eng._grange.counters
    assert c["batched_sweeps"] == 1 and c["hists_sweeps"] == 0
    assert set(eng._hists_cache) == {id(s) for s in samples[:3]}
    for s in samples[:3]:
        sk, sc = s.sorted_view()
        np.testing.assert_array_equal(eng._hists_cache[id(s)][1],
                                      eng._grange.hists(sk, sc))
    eng.prefetch(samples[:1])           # one uncached sample: no sweep
    assert c["batched_sweeps"] == 1


def _opts_pair():
    port = runner.ContainOptions(device="cpu", pseudotax=True)
    ref = JOptions(pseudotax=True)
    return port, ref


def test_prefetched_sample_is_swept_once(grange_world, monkeypatch):
    """The JAX prefilter sweeps a prefetched grange sample a second time
    (candidates_mask never reads the prefetch cache); the port's reads the
    cached histogram: one batched sweep for the cohort, no per-sample
    sweep, and the JAX prefilter's candidates."""
    genomes, samples = grange_world
    cohort = samples[:3]
    eng = _grange_engine(genomes, monkeypatch)
    eng.prefetch(cohort)
    c = eng._grange.counters
    assert c["batched_sweeps"] == 1
    opts, jopts = _opts_pair()
    jgenomes = [JGenome(g.genome_kmers, None, g.file_name,
                        g.first_contig_name, g.c, g.k, g.gn_size,
                        g.min_spacing) for g in genomes]
    for s in cohort:
        got = prefilter_candidates(opts, s, genomes, eng)
        js = JSample(s.kmers, s.counts, s.c, s.k, s.file_name)
        want = j_prefilter(jopts, js, jgenomes, None)
        np.testing.assert_array_equal(got, want)
        assert got.size > 0
    assert c["hists_sweeps"] == 0 and c["mask_stream_masks"] == 0
    assert c["batched_sweeps"] == 1
    # without the prefetch, each sample is swept once by its mask
    fresh = _grange_engine(genomes, monkeypatch)
    for s in cohort:
        prefilter_candidates(opts, s, genomes, fresh)
    assert fresh._grange.counters["hists_sweeps"] == len(cohort)


# ---- the cohort loop -------------------------------------------------------

class _Engine:
    """Records prefetches; serves streams or not."""

    def __init__(self, streams):
        self.streams = streams
        self.prefetched = []

    def serves_streams(self):
        return self.streams

    def prefetch(self, samples):
        self.prefetched.append([s.file_name for s in samples])


def test_cohort_depth(monkeypatch):
    monkeypatch.delenv("SYLPH_COHORT_DEPTH", raising=False)
    assert runner.cohort_depth(_Engine(True)) == 1
    assert runner.cohort_depth(_Engine(False)) == 8
    monkeypatch.setenv("SYLPH_COHORT_DEPTH", "3")
    assert runner.cohort_depth(_Engine(True)) == 3


def test_cohorts_keep_input_order_and_skip_in_place(monkeypatch):
    """Loads finish out of order on the pool; results come out in input
    order, a sample that loads as None is skipped in place, and each
    cohort of more than one loaded sample is prefetched once."""
    monkeypatch.setenv("SYLPH_COHORT_DEPTH", "3")
    names = [f"s{i}" for i in range(7)]
    loaded_by = {}

    def fake_load(opts, rf, is_sketch, genome_sketches, engine):
        i = int(rf[0][1:])
        time.sleep(0.02 * (3 - i % 3))
        loaded_by[rf[0]] = threading.current_thread().name
        return None if rf[0] == "s4" else SequencesSketch(
            np.zeros(0, np.uint64), np.zeros(0, np.uint32), 100, 31, rf[0])

    monkeypatch.setattr(runner, "_load_sample", fake_load)
    monkeypatch.setattr(runner, "process_sample",
                        lambda opts, s, gs, eng: [s.file_name])
    eng = _Engine(False)
    opts = runner.ContainOptions(threads=3)
    out = list(runner._cohorts(opts, [([n], True) for n in names], [], eng))
    assert [rf[0] for rf, _ in out] == names
    assert [r for _, r in out] == [[n] if n != "s4" else None
                                   for n in names]
    assert eng.prefetched == [["s0", "s1", "s2"], ["s3", "s5"]]
    assert all(t != threading.current_thread().name
               for t in loaded_by.values())


def test_cohort_load_error_reaches_the_caller(monkeypatch):
    monkeypatch.setenv("SYLPH_COHORT_DEPTH", "2")

    def fake_load(opts, rf, *args):
        if rf[0] == "bad":
            raise SystemExit(1)
        return SequencesSketch(np.zeros(0, np.uint64),
                               np.zeros(0, np.uint32), 100, 31, rf[0])

    monkeypatch.setattr(runner, "_load_sample", fake_load)
    monkeypatch.setattr(runner, "process_sample",
                        lambda opts, s, gs, eng: [s.file_name])
    gen = runner._cohorts(runner.ContainOptions(), [(["a"], True),
                                                    (["b"], True),
                                                    (["bad"], True),
                                                    (["c"], True)], [],
                          _Engine(False))
    assert [rf[0] for rf, _ in (next(gen), next(gen))] == ["a", "b"]
    with pytest.raises(SystemExit):
        next(gen)
