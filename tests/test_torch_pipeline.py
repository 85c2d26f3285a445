"""The port's one-shot device pipeline (sylph_tpu_torch/gpu/pipeline.py) and
its parts against the JAX package's, on the CPU, inputs made by numpy from
a seed.

- The plain versions of B6, B9 and B10 (gpu/seed_pack.py) bit for bit
  against seed_pack_pallas, seed_pack_pallas_t and seed_compact_pallas in
  interpret mode (keys as int64 bit patterns of the (hi, lo) pairs).
- ``_sketch_compact`` / ``sketch_batch`` in both branches, compact_rows,
  merge_join_hist and bucket_join_hist exactly.
- stats_from_histograms against the JAX f32 statistics: integer and
  boolean fields exactly, float fields to rtol 1e-5 (torch's and XLA's f32
  pow, exp and gammainc differ in the last bits); and against the host f64
  chain at tests/test_tpu_path.py::TestDeviceStats' tolerances.
- profile_step, finish_profile and finish_profile_batched: histograms equal
  to JAX's, stats within the tolerance above.
- the grange engine's occurrence-stream hist_device_stream against JAX's
  and a searchsorted oracle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sylph_tpu.tpu import pipeline as jpl
from sylph_tpu.tpu import u64
from sylph_tpu.tpu.containment import compact_rows as j_compact_rows
from sylph_tpu.tpu.containment import merge_join_hist as j_merge_join_hist
from sylph_tpu.tpu.pallas_seeding import (seed_compact_pallas,
                                          seed_pack_pallas,
                                          seed_pack_pallas_t)
from sylph_tpu.tpu.stats import stats_from_histograms as j_stats
from sylph_tpu_torch.gpu import pipeline as tpl
from sylph_tpu_torch.gpu import seed_pack as sp
from sylph_tpu_torch.gpu.containment import (compact_rows,
                                             host_index_from_jax,
                                             merge_join_hist)
from sylph_tpu_torch.gpu.keys import from_pair_np
from sylph_tpu_torch.gpu.stats import GenomeStats, stats_from_histograms
from tests import test_tpu_path as jtp
from tests.test_tpu_path import _random_reads

torch.set_num_threads(1)
SENT = np.uint32(0xFFFFFFFF)
_INT_FIELDS = ("contained", "n_inliers", "median_cov", "lam_valid", "valid")
_FLOAT_FIELDS = ("naive_ani", "final_ani", "final_cov", "lam", "mean_cov")


def _keys(pair) -> np.ndarray:
    return from_pair_np(np.asarray(pair[0]), np.asarray(pair[1]))


def _batch(seed, N, L, k):
    """[N, L] uint32 codes and int32 lengths in k..L (a few rows empty)."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(N, L)).astype(np.uint32)
    lengths = rng.integers(k, L + 1, size=N).astype(np.int32)
    lengths[::7] = 0
    return bases, lengths


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- B6, B9, B10: plain versions against the Pallas kernels ----------------

_PACK_CASES = [(200, 31, 256), (20, 31, 256), (5, 21, 256),
               (2, 31, 512)]      # the last overflows 128 survivors a read


@pytest.mark.parametrize("c,k,L", _PACK_CASES)
def test_seed_pack_plain_matches_pallas(c, k, L):
    bases, lengths = _batch(c + k, 16, L, k)
    want = _keys(seed_pack_pallas(bases, lengths, c=c, k=k, interpret=True))
    got = sp.seed_pack(_t(bases.astype(np.uint8)), _t(lengths), c=c, k=k)
    assert got.dtype == torch.int64 and got.shape == (16, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    live = (want != -1).sum(axis=1)
    assert live.max() > 0
    if c == 2:
        assert live.max() == 128


@pytest.mark.parametrize("c,k,L", _PACK_CASES)
def test_seed_pack_t_plain_matches_pallas(c, k, L):
    bases, lengths = _batch(c + k + 1, 16, L, k)
    bt = np.ascontiguousarray(bases.T)
    want = _keys(seed_pack_pallas_t(bt, lengths, c=c, k=k, interpret=True))
    got = sp.seed_pack_t(_t(bt.astype(np.uint8)), _t(lengths), c=c, k=k)
    assert got.shape == (sp.cap_rows_t(L, c), 16) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if c == 2:                # more than B6's 128 lanes, within cap_rows
        assert (want != -1).sum(axis=0).max() > 128


@pytest.mark.parametrize("c,k,L", [(5, 21, 256), (2, 31, 512), (7, 15, 256)])
def test_seed_compact_plain_matches_pallas(c, k, L):
    bases, lengths = _batch(c + k + 2, 16, L, k)
    want = _keys(seed_compact_pallas(bases, lengths, c=c, k=k,
                                     interpret=True))
    got = sp.seed_compact(_t(bases.astype(np.uint8)), _t(lengths), c=c, k=k)
    np.testing.assert_array_equal(got.numpy(), want)
    # B10 is B6 capped at min(128, 4L/c + 8): one kernel serves both
    b6 = sp.seed_pack_plain(_t(bases), _t(lengths), c=c, k=k)
    cap = sp.compact_cap(L, c)
    np.testing.assert_array_equal(got[:, :cap].numpy(), b6[:, :cap].numpy())
    assert (got[:, cap:] == -1).all()


def test_wrappers_reject_what_pallas_rejects():
    b = torch.zeros((300, 256), dtype=torch.uint8)
    n = torch.full((300,), 256, dtype=torch.int32)
    for fn, args in ((sp.seed_pack, (b[:, :200], n)),
                     (sp.seed_pack, (b, n)),                  # 300 % 256
                     (sp.seed_compact, (b[:, :200], n))):
        with pytest.raises(ValueError):
            fn(*args, c=20, k=31)
    with pytest.raises(ValueError, match="k must be"):
        sp.seed_pack(b[:256], n[:256], c=20, k=16)
    with pytest.raises(ValueError, match="k must be"):
        sp.seed_pack_t(b[:256].t(), n[:256], c=20, k=16)
    with pytest.raises(ValueError, match="multiple of 8"):
        sp.seed_pack_t(b[:12, :4], n[:4], c=20, k=31)
    with pytest.raises(ValueError, match="multiple of 512"):
        sp.seed_pack_t(torch.zeros((8, 600), dtype=torch.uint8),
                       torch.zeros(600, dtype=torch.int32), c=20, k=31)
    with pytest.raises(ValueError, match="k must be"):
        sp.seed_compact(b[:256], n[:256], c=20, k=32)


@pytest.mark.parametrize("n,resident,grid", [
    (65536, 660, 660),        # (q)'s batch on 132 SMs at 5 blocks a SM
    (1, 528, 1), (7, 528, 1), (9, 528, 2), (256, 528, 32), (8, 3, 1),
    (0, 528, 0)])
def test_seed_pack_row_grid(n, resident, grid):
    """csrc/seed_pack.cu's row-kernel grid: a warp a read, 8 a block, at
    most the resident blocks (which then stride over the reads)."""
    assert sp.row_grid(n, resident) == grid
    assert grid * sp.ROW_WARPS >= min(n, resident * sp.ROW_WARPS)


@pytest.mark.parametrize("n,blocks", [
    (65536, 512),             # (s)'s batch
    (4096, 32), (512, 4), (100, 1), (8, 1), (0, 0)])
def test_seed_pack_col_blocks(n, blocks):
    """csrc/seed_pack.cu's column-kernel grid: a block a tile of 128 read
    columns, the last tile partial."""
    assert sp.col_blocks(n) == blocks
    assert blocks * sp.COL_TILE >= n > (blocks - 1) * sp.COL_TILE or n == 0


# ---- _sketch_compact / sketch_batch ----------------------------------------

def test_sketch_batch_kernel_branch_matches_pallas():
    """L = 256: the port takes B6 (its plain version here), cut to the
    capacity, where the JAX package takes seed_pack_pallas on its TPU; the
    count equals the JAX CPU path's (the fallback) as no read overflows."""
    c, k, L = 20, 31, 256
    bases, lengths = _batch(3, 32, L, k)
    keys, n = tpl.sketch_batch(bases, lengths, c=c, k=k, device="cpu")
    cap = min(128, 4 * L // c + 8)
    want = _keys(seed_pack_pallas(bases, lengths, c=c, k=k,
                                  interpret=True))[:, :cap]
    np.testing.assert_array_equal(keys.numpy(), want)
    _hi, _lo, jn = jpl.sketch_batch(bases, lengths, c=c, k=k)
    assert n.dtype == torch.int32 and int(n) == int(jn) == (want != -1).sum()


@pytest.mark.parametrize("c,k,L", [(20, 31, 100), (20, 15, 100), (1, 21, 100),
                                   (20, 15, 256)])
def test_sketch_batch_fallback_matches_jax(c, k, L):
    """The fallback (seeding, then the row sort of compact_rows) gives the
    JAX package's sketch_batch bit for bit, layout and order included: at
    L = 100 (TestPipeline's reads), at k <= 16, at c = 1 (hashes at or
    above 2^63 sort after the others), and at L = 256 with k = 15, where
    the seeding is B7's (packed on the device first)."""
    rng = np.random.default_rng(c * 100 + k + L)
    bases, lengths = jpl.pack_reads(_random_reads(rng, 40, lo=k, hi=L + 1),
                                    L)
    chi, clo, jn = jpl.sketch_batch(bases, lengths, c=c, k=k)
    want = _keys((chi, clo))
    keys, n = tpl.sketch_batch(bases, lengths, c=c, k=k, device="cpu")
    assert keys.shape == want.shape
    np.testing.assert_array_equal(keys.numpy(), want)
    assert int(n) == int(jn)
    if c == 1:
        assert (want < -1).any()        # top-bit hashes, not pads
    b2, l2 = tpl.pack_reads(_random_reads(np.random.default_rng(
        c * 100 + k + L), 40, lo=k, hi=L + 1), L)
    np.testing.assert_array_equal(b2, bases)
    np.testing.assert_array_equal(l2, lengths)


def test_sketch_batch_packed_matches_sketch_batch():
    c, k, L = 20, 31, 256
    bases, lengths = _batch(4, 24, L, k)
    packed = tpl.pack_bases_u32(bases)
    np.testing.assert_array_equal(packed, jpl.pack_bases_u32(bases))
    a, na = tpl.sketch_batch(bases, lengths, c=c, k=k, device="cpu")
    b, nb = tpl.sketch_batch_packed(packed, lengths, c=c, k=k, device="cpu")
    assert torch.equal(a, b) and int(na) == int(nb)
    jhi, jlo, _ = jpl.sketch_batch_packed(packed, lengths, c=c, k=k)
    jchi, jclo, _ = jpl.sketch_batch(bases, lengths, c=c, k=k)
    np.testing.assert_array_equal(_keys((jhi, jlo)), _keys((jchi, jclo)))


def test_entry_points_default_to_cuda(monkeypatch):
    """No entry point carries on on the CPU unless asked for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bases, lengths = _batch(5, 8, 256, 31)
    j = jpl.build_host_index([np.arange(10, dtype=np.uint64)])
    idx = (host_index_from_jax(j.hi, j.lo, j.genome_ids, j.n_kmers, 1)
           [:3])
    for call in (
            lambda: tpl.sketch_batch(bases, lengths, c=20, k=31),
            lambda: tpl.sketch_batch_packed(tpl.pack_bases_u32(bases),
                                            lengths, c=20, k=31),
            lambda: tpl.profile_step(bases, lengths, *idx, c=20, k=31,
                                     n_genomes=1),
            lambda: tpl.finish_profile(np.zeros(8, np.int64), *idx, k=31,
                                       n_genomes=1),
            lambda: tpl.finish_profile_batched(
                np.zeros((2, 8), np.int64), *idx, k=31, n_genomes=1)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()


# ---- joins -----------------------------------------------------------------

@pytest.mark.parametrize("hi_bits", [20, 32])
def test_compact_rows_matches_jax(hi_bits):
    """TestDeviceContainment's case, and one with high words up to
    0xFFFFFFFF (c = 1 hashes, the top bit set)."""
    rng = np.random.default_rng(6)
    n = 2000
    hi = rng.integers(0, 1 << hi_bits, size=n, dtype=np.uint32)
    hi[:5] = SENT                      # real hashes with the pad's high word
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    keep = rng.random(n) < 0.02
    keep[:5] = True
    want = _keys(jax.jit(j_compact_rows, static_argnums=(3, 4))(
        hi, lo, keep, 512, 32))
    got = compact_rows(_t(from_pair_np(hi, lo)), _t(keep), 512, 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_merge_join_hist_matches_jax():
    """tests/test_tpu_path.py::TestDeviceContainment's data."""
    rng = np.random.default_rng(7)
    uniq = rng.integers(0, 1 << 40, size=500, dtype=np.uint64)
    mult = rng.integers(1, 6, size=500)
    stream = np.repeat(uniq, mult)
    rng.shuffle(stream)
    pad = 4096 - stream.size
    shi, slo = u64.from_u64_np(stream)
    shi = np.concatenate([shi, np.full(pad, SENT, np.uint32)])
    slo = np.concatenate([slo, np.full(pad, SENT, np.uint32)])
    genomes = [rng.choice(uniq, size=50, replace=False).astype(np.uint64)
               for _ in range(5)]
    idx = jpl.build_host_index(genomes)
    G, H = 5, 16
    want = np.asarray(j_merge_join_hist(
        jnp.asarray(idx.hi), jnp.asarray(idx.lo),
        jnp.asarray(idx.genome_ids), jnp.asarray(shi), jnp.asarray(slo),
        n_genomes=G, n_buckets=H))
    pidx = host_index_from_jax(idx.hi, idx.lo, idx.genome_ids, idx.n_kmers,
                               idx.n_genomes)
    got = merge_join_hist(_t(pidx.keys), _t(pidx.genome_ids),
                          _t(from_pair_np(shi, slo)), n_genomes=G,
                          n_buckets=H)
    assert got.dtype == torch.int32 and got.shape == (G, H)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:, 1:].sum() > 0


def test_bucket_join_hist_matches_jax():
    """tests/test_bucket_join.py::test_bucket_join_hist_matches_merge_join's
    data: the port buckets the live k-mers only (B from the padded slot
    count, as the JAX layout takes it) and maps gids through their slots."""
    from sylph_tpu.tpu import bucket_join as jbj
    from sylph_tpu_torch.gpu import bucket_join as tbj
    rng = np.random.default_rng(5)
    c, G, H = 50, 7, 32
    thr = ((1 << 64) - 1) // c
    pool = rng.integers(0, thr, size=4000, dtype=np.uint64)
    genomes = [rng.choice(pool, size=400, replace=False).astype(np.uint64)
               for _ in range(G)]
    idx = jpl.build_host_index(genomes, pad_multiple=64)
    occ = np.sort(np.concatenate([
        rng.choice(pool, size=3000),
        rng.integers(0, thr, size=500, dtype=np.uint64)]))
    shi, slo = u64.from_u64_np(occ)
    pad = (-occ.size) % 512
    shi = np.concatenate([shi, np.full(pad, SENT, np.uint32)])
    slo = np.concatenate([slo, np.full(pad, SENT, np.uint32)])
    sw = (shi != SENT).astype(np.int32)
    bidx = jbj.build_bucketed_index(idx.hi, idx.lo, c)
    want = np.asarray(jbj.bucket_join_hist(
        jnp.asarray(bidx.hi), jnp.asarray(bidx.lo),
        jnp.asarray(jbj.build_gid_grid(bidx, idx.genome_ids, G)),
        jnp.asarray(shi), jnp.asarray(slo), jnp.asarray(sw),
        width=bidx.width, B=bidx.n_buckets,
        CS=jbj.sample_cs(occ.size, bidx.n_buckets), n_genomes=G,
        n_buckets=H, force_xla=True))
    pidx = host_index_from_jax(idx.hi, idx.lo, idx.genome_ids, idx.n_kmers,
                               G)
    live = pidx.genome_ids < G
    tb = tbj.build_bucketed_index(pidx.keys[live], c,
                                  n_slots=pidx.keys.size)
    assert (tb.width, tb.n_buckets) == (bidx.width, bidx.n_buckets)
    grid = tbj.build_gid_grid(tb, pidx.genome_ids[live], G)
    assert grid.dtype == torch.int32 and int((grid < G).sum()) == live.sum()
    got = tbj.bucket_join_hist(
        tb.key, grid, _t(from_pair_np(shi, slo)), _t(sw), width=tb.width,
        B=tb.n_buckets, CS=tbj.sample_cs(occ.size, tb.n_buckets),
        n_genomes=G, n_buckets=H)
    np.testing.assert_array_equal(got.numpy(), want)
    want_merge = np.asarray(j_merge_join_hist(
        jnp.asarray(idx.hi), jnp.asarray(idx.lo),
        jnp.asarray(idx.genome_ids), jnp.asarray(shi), jnp.asarray(slo),
        n_genomes=G, n_buckets=H))
    np.testing.assert_array_equal(got.numpy(), want_merge)


# ---- statistics ------------------------------------------------------------

def _assert_stats_close(got: GenomeStats, want):
    """Integer and boolean fields exact; float fields to rtol 1e-5, exact
    where JAX's value is (atol 0)."""
    for f in _INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in _FLOAT_FIELDS:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        assert g.dtype == np.float32, f
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=f)
    assert got.contained.dtype == torch.int32
    assert got.valid.dtype == torch.bool


def _random_hists(seed, G, H):
    """Poisson-like histograms at coverages 0.05..40 (the Poisson cut and
    the median >= 30 branch both taken), some genomes empty."""
    rng = np.random.default_rng(seed)
    hist = np.zeros((G, H), np.int32)
    n_kmers = rng.integers(20, 5000, size=G).astype(np.int32)
    for g in range(G):
        lam = float(rng.choice([rng.uniform(0.05, 4.0),
                                rng.uniform(4.0, 40.0)]))
        covs = np.minimum(rng.poisson(lam, size=int(n_kmers[g])), H - 1)
        if g % 9 == 0:
            covs[:] = 0
        hist[g] = np.bincount(covs, minlength=H)
    return hist, n_kmers


@pytest.mark.parametrize("H", [64, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_stats_match_jax(H, seed):
    hist, n_kmers = _random_hists(seed, 48, H)
    kw = dict(k=31, min_ani=0.9)
    want = j_stats(jnp.asarray(hist), jnp.asarray(n_kmers), **kw)
    got = stats_from_histograms(_t(hist), _t(n_kmers), **kw)
    _assert_stats_close(got, want)
    assert np.asarray(want.lam_valid).any() and np.asarray(want.valid).any()
    # a leading sample axis gives the rows' own statistics
    both = stats_from_histograms(_t(np.stack([hist, hist[::-1]])),
                                 _t(n_kmers), **kw)
    assert both.naive_ani.shape == (2, 48)
    for f in GenomeStats._fields:
        assert torch.equal(getattr(both, f)[0], getattr(got, f)), f


@pytest.mark.parametrize("seed", range(6))
def test_stats_match_host_chain(seed):
    """TestDeviceStats' data and tolerances against the host f64 chain."""
    rng = np.random.default_rng(seed)
    G, H, k = 8, 64, 31
    hist = np.zeros((G, H), np.int32)
    n_kmers = np.zeros(G, np.int32)
    cov_lists = []
    for g in range(G):
        n = int(rng.integers(60, 4000))
        lam = float(rng.uniform(0.05, 4.0))
        covs = rng.poisson(lam, size=n)
        covs = np.minimum(covs[covs > 0], H - 1)
        n_kmers[g] = n
        cov_lists.append(covs)
        for v in covs:
            hist[g, v] += 1
        hist[g, 0] = 0
    st = stats_from_histograms(_t(hist), _t(n_kmers), k=k, min_ani=0.0,
                               min_number_kmers=50.0)
    host = jtp.TestDeviceStats()
    for g in range(G):
        covs = cov_lists[g]
        if covs.size == 0:
            continue
        hs = host._host_stats(covs, int(n_kmers[g]), k, 0.0)
        assert hs is not None
        np.testing.assert_allclose(float(st.naive_ani[g]), hs.naive_ani,
                                   rtol=2e-6)
        assert float(st.median_cov[g]) == hs.median_cov
        np.testing.assert_allclose(float(st.mean_cov[g]), hs.mean_cov,
                                   rtol=2e-5)
        np.testing.assert_allclose(float(st.final_cov[g]),
                                   hs.final_est_cov, rtol=2e-4)
        np.testing.assert_allclose(float(st.final_ani[g]),
                                   hs.final_est_ani, rtol=2e-5)


# ---- the pipeline as a whole -----------------------------------------------

def _world(seed, L, c=20, k=31, G=3):
    """TestPipeline's world (64 random reads, genomes half drawn from their
    survivors), the reads padded to L; the index carried across with
    host_index_from_jax."""
    bases, lengths, idx, want = jtp.TestPipeline()._setup(
        np.random.default_rng(seed), c=c, k=k, G=G)
    if L > bases.shape[1]:
        bases = np.pad(bases, ((0, 0), (0, L - bases.shape[1])))
    pidx = host_index_from_jax(idx.hi, idx.lo, idx.genome_ids, idx.n_kmers,
                               idx.n_genomes)
    return bases, lengths, idx, pidx, want


_KW = dict(k=31, n_genomes=3, n_buckets=64, min_ani=0.5)


@pytest.mark.parametrize("L", [100, 256])
def test_profile_step_matches_jax(L):
    """L = 100 takes the fallback on both packages; L = 256 takes B6 in the
    port and the fallback in JAX on the CPU, equal while no read overflows
    the capacity."""
    bases, lengths, idx, pidx, want = _world(8, L)
    jh, jst = jpl.profile_step(bases, lengths, idx.hi, idx.lo,
                               idx.genome_ids, idx.n_kmers, c=20, **_KW)
    h, st = tpl.profile_step(bases, lengths, pidx.keys, pidx.genome_ids,
                             pidx.n_kmers, c=20, device="cpu", **_KW)
    assert h.dtype == torch.int32
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(h.numpy(), want)
    _assert_stats_close(st, jst)
    keys, _n = tpl.sketch_batch(bases, lengths, c=20, k=31, device="cpu")
    if L == 256:
        assert keys.shape == (bases.shape[0], 4 * L // 20 + 8)
        assert (keys[:, -1] == -1).all()          # no read at the cap


@pytest.mark.parametrize("L", [100, 256])
def test_two_phase_and_batched_match_jax(L):
    bases, lengths, idx, pidx, want = _world(9, L)
    keys, n = tpl.sketch_batch(bases, lengths, c=20, k=31, device="cpu")
    h, st = tpl.finish_profile(keys, pidx.keys, pidx.genome_ids,
                               pidx.n_kmers, device="cpu", **_KW)
    np.testing.assert_array_equal(h.numpy(), want)
    chi, clo, jn = jpl.sketch_batch(bases, lengths, c=20, k=31)
    jh, jst = jpl.finish_profile(chi, clo, idx.hi, idx.lo, idx.genome_ids,
                                 idx.n_kmers, **_KW)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    _assert_stats_close(st, jst)
    assert int(n) == int(jn)
    # four samples against the same index, as TestPipeline's batched test
    rows, jrows = [], []
    for s in range(4):
        b, ln, _i, _w = jtp.TestPipeline()._setup(
            np.random.default_rng(100 + s))
        b = np.pad(b, ((0, 0), (0, L - b.shape[1])))
        rows.append(tpl.sketch_batch(b, ln, c=20, k=31,
                                     device="cpu")[0].reshape(-1))
        c2 = jpl.sketch_batch(b, ln, c=20, k=31)
        jrows.append((np.asarray(c2[0]).reshape(-1),
                      np.asarray(c2[1]).reshape(-1)))
    width = max(r.numel() for r in rows)
    smp = torch.stack([torch.cat([r, torch.full((width - r.numel(),), -1)])
                       for r in rows])
    hb, stb = tpl.finish_profile_batched(smp, pidx.keys, pidx.genome_ids,
                                         pidx.n_kmers, device="cpu", **_KW)
    jhb, jstb = jpl.finish_profile_batched(
        np.stack([r[0] for r in jrows]), np.stack([r[1] for r in jrows]),
        idx.hi, idx.lo, idx.genome_ids, idx.n_kmers, **_KW)
    assert hb.shape == (4, 3, 64) and stb.naive_ani.shape == (4, 3)
    np.testing.assert_array_equal(hb.numpy(), np.asarray(jhb))
    _assert_stats_close(stb, jstb)
    for s in range(4):
        one, _st = tpl.finish_profile(rows[s], pidx.keys, pidx.genome_ids,
                                      pidx.n_kmers, device="cpu", **_KW)
        assert torch.equal(one, hb[s])


def test_transposed_seed_branch(monkeypatch):
    """SYLPH_SEED_T=1 (the module flag, read at import) takes B9: the keys
    come read-per-column and the histograms do not change."""
    bases, lengths, idx, pidx, want = _world(10, 256)
    plain, _n = tpl.sketch_batch(bases, lengths, c=20, k=31, device="cpu")
    monkeypatch.setattr(tpl, "_USE_TRANSPOSED_SEED", True)
    keys, n = tpl.sketch_batch(bases, lengths, c=20, k=31, device="cpu")
    assert keys.shape == (sp.cap_rows_t(256, 20), bases.shape[0])
    assert int(n) == int(_n)
    bt = np.ascontiguousarray(bases.T)
    np.testing.assert_array_equal(keys.numpy(), _keys(seed_pack_pallas_t(
        bt, lengths, c=20, k=31, interpret=True)))
    h, _st = tpl.profile_step(bases, lengths, pidx.keys, pidx.genome_ids,
                              pidx.n_kmers, c=20, device="cpu", **_KW)
    np.testing.assert_array_equal(h.numpy(), want)
    assert torch.equal(torch.sort(keys.reshape(-1)).values,
                       torch.sort(torch.cat([
                           plain.reshape(-1),
                           torch.full((keys.numel() - plain.numel(),),
                                      -1)])).values)


# ---- grange: the occurrence-stream sweep -----------------------------------

@pytest.mark.parametrize("order", ["shuffled", "pads_first"])
def test_grange_occurrence_stream_matches_jax(order):
    """hist_device_stream(keys) with no weights folds the occurrence stream
    on the device (pads scattered through it unsorted, or all ahead of the
    sorted live keys, where an int64 sort would put them) and equals the
    JAX engine's folded stream sweep and the searchsorted oracle."""
    import sylph_tpu.tpu.grange as jgr
    from sylph_tpu_torch.gpu import grange as tgr
    from tests.test_grange import _oracle_hists, _world as _gworld

    kmers, gids, sk, sc = _gworld(9, m=150_000, t=4_000)
    G = 50
    gidx = jgr.build_grange_index(kmers, gids, G, chunk_slots=1 << 15,
                                  target_mean=128)
    assert gidx.spill_kmers.size == 0 and gidx.n_heavy == 0
    sc3 = np.minimum(sc, 3)
    occ = np.repeat(sk, sc3)
    shi, slo = u64.from_u64_np(occ)
    pad = (1 << int(np.ceil(np.log2(occ.size + 1)))) - occ.size
    shi = np.concatenate([shi, np.full(pad, SENT, np.uint32)])
    slo = np.concatenate([slo, np.full(pad, SENT, np.uint32)])
    jshi, jslo = jax.lax.sort((jnp.asarray(shi), jnp.asarray(slo)),
                              num_keys=2)
    jeng = jgr.GRangeEngine(gidx, devices=[jax.devices()[0]])
    jh, check = jeng.hist_device_stream(jshi, jslo)
    assert check()
    want = np.asarray(jh)[:G * 64].reshape(G, 64).astype(np.int64)
    np.testing.assert_array_equal(
        want, _oracle_hists(kmers, gids, G, sk, sc3.astype(np.uint32)))

    stream = from_pair_np(shi, slo)          # live keys sorted, pads last
    if order == "shuffled":
        np.random.default_rng(1).shuffle(stream)
    else:
        stream = np.roll(stream, pad)
        assert (stream[:pad] == -1).all() and (stream[pad:] != -1).all()
    eng = tgr.GRangeEngine(tgr.index_from_numpy(gidx._asdict()),
                           device="cpu")
    hist, probe, P = eng.hist_device_stream(_t(stream.reshape(-1, 64)))
    assert int(probe[0]) == 0 and int(probe[1]) <= P
    got = hist[:G * 64].view(G, 64).numpy()
    np.testing.assert_array_equal(got, want)
    # the folded table is the host table: the weighted form agrees
    skey, w = eng.upload_sample(sk, sc3.astype(np.uint32))
    h2, _p, _P = eng.hist_device_stream(skey, w)
    assert torch.equal(h2, hist)


def test_b9_layout_flattened_by_row_loses_survivors():
    """Found in the JAX reference (ROADMAP C): B9's [cap_rows, N] layout
    holds every read's first survivor in row 0, its second in row 1, ...;
    flattened row by row, as bench.py's profile config and
    make_sharded_profile_step flatten _sketch_compact's output before
    condense_stream, the first windows are nearly all live and overflow
    capacities sized by the mean density. The JAX package's condense_stream
    (its repack kernel in interpret mode) and the port's drop the same
    survivors; flattened read by read the stream condenses losslessly."""
    from sylph_tpu_torch.gpu.bucket_fill import condense_stream
    c, k, L, N = 20, 31, 256, 1024
    bases, lengths = _batch(11, N, L, k)
    keys = sp.seed_pack_t(_t(bases.T.astype(np.uint8)), _t(lengths), c=c,
                          k=k)
    n_live = int((keys != -1).sum())
    live = n_live / keys.numel()
    flat = keys.reshape(-1).numpy()
    hi = ((flat >> 32) & 0xFFFFFFFF).astype(np.uint32)
    lo = (flat & 0xFFFFFFFF).astype(np.uint32)
    jh, jl = jpl.condense_stream(jnp.asarray(hi), jnp.asarray(lo), live,
                                 interpret=True)
    by_row = condense_stream(keys.reshape(-1), live)
    np.testing.assert_array_equal(by_row.numpy(), _keys((jh, jl)))
    assert int((by_row != -1).sum()) < 0.8 * n_live
    by_read = condense_stream(keys.t().reshape(-1), live)
    assert int((by_read != -1).sum()) == n_live
    assert by_read.numel() < keys.numel()


def test_count_includes_survivors_with_the_pad_high_word():
    """Divergence from the JAX package (ROADMAP C): its sketch_batch counts
    entries whose high word is not 0xFFFFFFFF, so at c = 1 a survivor hash
    with that high word (one window in 2^32) is left out of n; the port
    counts every key but the -1 pad. A read carrying such a 31-mer."""
    from sylph_tpu_torch.kmer.hashing import inv_mm_hash64_np
    k = 31
    for low in range(1, 64):
        v = int(inv_mm_hash64_np(np.array([(0xFFFFFFFF << 32) | low],
                                          np.uint64))[0])
        rc = int("".join("3210"[(v >> 2 * i) & 3] for i in range(k)), 4)
        if v < 1 << 62 and v <= rc:
            break
    seq = "".join("ACGT"[(v >> 2 * (k - 1 - i)) & 3] for i in range(k))
    rng = np.random.default_rng(3)
    reads = _random_reads(rng, 7) + [b"AC" + seq.encode() + b"GT"]
    bases, lengths = jpl.pack_reads(reads, 100)
    chi, clo, jn = jpl.sketch_batch(bases, lengths, c=1, k=k)
    keys, n = tpl.sketch_batch(bases, lengths, c=1, k=k, device="cpu")
    want = _keys((chi, clo))
    np.testing.assert_array_equal(keys.numpy(), want)
    assert ((want >> 32) == -1).sum() - (want == -1).sum() == 1
    assert int(n) == int((want != -1).sum()) == int(jn) + 1
