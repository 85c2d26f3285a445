"""Plain PyTorch versions of the port's kernels (sylph_tpu_torch/gpu) vs the
JAX package's Pallas kernels in interpret mode, on the CPU.

Each port wrapper runs its plain version for CPU tensors, so these are the
arithmetic the CUDA kernels (csrc/*.cu) are held to on the card. Outputs
and live counts must be bit-identical: keys compare as int64 bit patterns
of the JAX (hi, lo) uint32 pairs, codes as int32 bit patterns of the JAX
uint32 codes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sylph_tpu.tpu import grange as jgr
from sylph_tpu.tpu.bucket_fill import (bucket_fill_pallas, fill_geometry,
                                       repack1_flat as j_repack1_flat,
                                       repack2_flat as j_repack2_flat)
from sylph_tpu.tpu.bucket_join import (_join_xla_tiled, _sample_to_buckets,
                                       bucket_join_counts, bucket_join_device,
                                       build_bucketed_index)
from sylph_tpu.tpu.u64 import from_u64_np
from sylph_tpu_torch.gpu import bucket_fill as bf
from sylph_tpu_torch.gpu.bucket_fill import bucket_fill, repack1_flat
from sylph_tpu_torch.gpu import bucket_join as bj
from sylph_tpu_torch.gpu.bucket_join import (join_codes, join_codes_compact,
                                             join_counts, sample_cs)
from sylph_tpu_torch.gpu.keys import from_pair_np
from tests.test_bucket_fill import _case
from tests.test_bucket_join import _world as _bucket_world
from tests.test_fused_codes import _chunk_world, _tiled_world
from tests.test_torch_cuda import _adversarial_join

torch.set_num_threads(1)
SENT = np.uint32(0xFFFFFFFF)


def _keys(hi, lo) -> torch.Tensor:
    return torch.from_numpy(from_pair_np(np.asarray(hi), np.asarray(lo)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _codes_i32(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


# ---- B1: cell-grid fill ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("P,B,CS,width,nt", [
    (4096, 512, 8, 16, 1),
    (4096, 128, 8, 64, 4),         # tiled: cells = bucket*nt + sub-range
])
def test_fill_matches_pallas_and_scatter(seed, P, B, CS, width, nt):
    base = 1000 + seed * 37
    subw = -(-width // nt) if nt > 1 else 0
    shi, slo, sw = _case(seed, P, B, width, base)
    ref = _sample_to_buckets(jnp.asarray(shi), jnp.asarray(slo),
                             jnp.asarray(sw), width=width, B=B, CS=CS,
                             base=base, nt=nt, subwidth=subw)
    dk, dw = bucket_fill(_keys(shi, slo), _t(sw), base, width=width, B=B,
                         CS=CS, nt=nt, subwidth=subw)
    np.testing.assert_array_equal(dk.numpy(), from_pair_np(ref[0], ref[1]))
    np.testing.assert_array_equal(dw.numpy(), np.asarray(ref[2]))
    assert fill_geometry(B * nt, CS) is not None
    pal = bucket_fill_pallas(jnp.asarray(shi), jnp.asarray(slo),
                             jnp.asarray(sw), jnp.uint32(base), width=width,
                             B=B, CS=CS, interpret=True, nt=nt,
                             subwidth=subw)
    # the Pallas fill drops entries its input window does not cover; where
    # it keeps every entry (as here) it equals the scatter exactly
    assert int(np.asarray(pal[2]).sum()) == int(dw.sum())
    np.testing.assert_array_equal(dk.numpy(), from_pair_np(pal[0], pal[1]))
    np.testing.assert_array_equal(dw.numpy(), np.asarray(pal[2]))


def test_fill_keeps_what_the_pallas_window_drops():
    """A window with more entries than its two fetched input blocks: the
    Pallas fill drops some (its conservation scalar sees it), the port's
    fill keeps all of them, exactly as the scatter oracle does."""
    B, CS, width = 512, 8, 16
    TBK, W_out = fill_geometry(B, CS)
    P, n = 8 * W_out, 3 * W_out
    rng = np.random.default_rng(0)
    his = (1000 + rng.integers(0, TBK * width, size=n)).astype(np.uint32)
    los = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    order = np.lexsort((los, his))
    shi = np.full(P, SENT, np.uint32)
    slo = np.full(P, SENT, np.uint32)
    sw = np.zeros(P, np.int32)
    shi[:n], slo[:n], sw[:n] = his[order], los[order], 1
    ref = _sample_to_buckets(jnp.asarray(shi), jnp.asarray(slo),
                             jnp.asarray(sw), width=width, B=B, CS=CS,
                             base=1000)
    pal = bucket_fill_pallas(jnp.asarray(shi), jnp.asarray(slo),
                             jnp.asarray(sw), jnp.uint32(1000), width=width,
                             B=B, CS=CS, interpret=True)
    dk, dw = bucket_fill(_keys(shi, slo), _t(sw), 1000, width=width, B=B,
                         CS=CS)
    assert np.asarray(pal[2]).sum() < int(dw.sum())
    np.testing.assert_array_equal(dk.numpy(), from_pair_np(ref[0], ref[1]))
    np.testing.assert_array_equal(dw.numpy(), np.asarray(ref[2]))


def test_fill_over_capacity_detected():
    """Cells deeper than CS drop their tail; the weight-conservation
    scalar of the engine (w_in vs sum of the grid) sees the loss."""
    B, CS, width = 64, 4, 16
    shi, slo, sw = _case(5, 2048, B, width, 500, dup_frac=0.0,
                         zero_frac=0.0, oor_frac=0.0)
    ref = _sample_to_buckets(jnp.asarray(shi), jnp.asarray(slo),
                             jnp.asarray(sw), width=width, B=B, CS=CS,
                             base=500)
    dk, dw = bucket_fill(_keys(shi, slo), _t(sw), 500, width=width, B=B,
                         CS=CS)
    np.testing.assert_array_equal(dk.numpy(), from_pair_np(ref[0], ref[1]))
    np.testing.assert_array_equal(dw.numpy(), np.asarray(ref[2]))
    assert int(dw.sum()) < int(sw.sum())


# ---- B2 / B4 / B5: the compare kernel --------------------------------------

def _flat_cells(seed, B=128, CI=16, CS=8, G=9):
    ihi, ilo, gid, sh, sl, sw, base, width, B, CS, G = _chunk_world(
        seed, B=B, CI=CI, CS=CS, G=G)
    dh, dl, dw = _sample_to_buckets(sh, sl, sw, width=width, B=B, CS=CS,
                                    base=int(base))
    return ihi, ilo, gid, dh, dl, dw, G, 1, 0


def _tiled_cells(seed):
    (ihi, ilo, gid, sh, sl, sw, base, width, B, CS, G, nt, subw,
     ov) = _tiled_world(seed)
    dh, dl, dw = _sample_to_buckets(sh, sl, sw, width=width, B=B, CS=CS,
                                    base=int(base), nt=nt, subwidth=subw)
    LW = nt * CS
    tile = (ihi.shape[1] - ov) // nt
    return (ihi, ilo, gid, dh.reshape(B, LW), dl.reshape(B, LW),
            dw.reshape(B, LW), G, nt, tile)


def _port_args(ihi, ilo, gid, dh, dl, dw):
    return _keys(ihi, ilo), _t(gid), _keys(dh, dl), _t(dw)


@pytest.mark.parametrize("layout,seed,capr", [
    ("flat", 0, 8), ("flat", 5, 16), ("tiled", 1, 8), ("tiled", 2, 16)])
def test_join_codes_compact_matches_pallas(layout, seed, capr, monkeypatch):
    monkeypatch.setattr(jgr, "_CODES_INTERPRET", True)
    ihi, ilo, gid, dh, dl, dw, G, nt, tile = (
        _flat_cells(seed) if layout == "flat" else _tiled_cells(seed))
    want, want_nl = jgr._codes_from_buckets_compact(
        ihi, ilo, gid, dh, dl, dw, G=G, H=jgr.HIST_H, CAPR=capr, nt=nt,
        tile=tile)
    got, got_nl = join_codes_compact(*_port_args(ihi, ilo, gid, dh, dl, dw),
                                     G=G, CAPR=capr, nt=nt, tile=tile)
    np.testing.assert_array_equal(got.numpy(), _codes_i32(want))
    assert int(got_nl) == int(want_nl) > 0


def test_join_codes_compact_overflow_detected(monkeypatch):
    """A column deeper than CAPR: n_live counts every live slot while the
    emitted block keeps CAPR per column, as in the Pallas kernel."""
    monkeypatch.setattr(jgr, "_CODES_INTERPRET", True)
    B, CI, G, width = 8, 16, 3, 32
    ihi = np.repeat((100 + np.arange(B) * width).astype(np.uint32)[:, None],
                    CI, axis=1)
    ilo = np.full((B, CI), 7, np.uint32)
    gid = np.ones((B, CI), np.int32)
    sh = np.full(64, SENT, np.uint32)
    sl = np.full(64, SENT, np.uint32)
    sw = np.zeros(64, np.int32)
    sh[:B], sl[:B], sw[:B] = ihi[:, 0], 7, 1
    dh, dl, dw = _sample_to_buckets(jnp.asarray(sh), jnp.asarray(sl),
                                    jnp.asarray(sw), width=width, B=B, CS=4,
                                    base=100)
    args = (jnp.asarray(ihi), jnp.asarray(ilo), jnp.asarray(gid), dh, dl, dw)
    want, want_nl = jgr._codes_from_buckets_compact(*args, G=G,
                                                    H=jgr.HIST_H, CAPR=4)
    got, got_nl = join_codes_compact(*_port_args(*args), G=G, CAPR=4)
    np.testing.assert_array_equal(got.numpy(), _codes_i32(want))
    assert int(got_nl) == int(want_nl) == B * CI
    assert int((got != -1).sum()) == B * CI // 2      # the visible drop


@pytest.mark.parametrize("layout,seed", [("flat", 1), ("tiled", 3)])
def test_join_codes_matches_pallas(layout, seed, monkeypatch):
    monkeypatch.setattr(jgr, "_CODES_INTERPRET", True)
    ihi, ilo, gid, dh, dl, dw, G, nt, tile = (
        _flat_cells(seed) if layout == "flat" else _tiled_cells(seed))
    want = jgr._codes_from_buckets(ihi, ilo, gid, dh, dl, dw, G=G,
                                   H=jgr.HIST_H, nt=nt, tile=tile)
    got = join_codes(*_port_args(ihi, ilo, gid, dh, dl, dw), G=G, nt=nt,
                     tile=tile)
    np.testing.assert_array_equal(got.numpy(), _codes_i32(want))
    assert int((got != -1).sum()) > 0


@pytest.mark.parametrize("seed", [0, 2])
def test_join_counts_matches_pallas(seed):
    """B5 flat: fill + count grid vs bucket_join_device's Pallas join
    kernel (interpret mode)."""
    ihi, ilo, gid, sh, sl, sw, base, width, B, CS, G = _chunk_world(seed)
    want = bucket_join_device(ihi, ilo, sh, sl, sw, width=width, B=B, CS=CS,
                              base=int(base), interpret=True)
    dk, dw = bucket_fill(_keys(sh, sl), _t(sw), int(base), width=width, B=B,
                         CS=CS)
    got = join_counts(_keys(ihi, ilo), dk, dw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


def test_join_counts_matches_bucket_join_counts():
    """B5 at the whole-range bucket layout vs bucket_join_counts (the
    Pallas join kernel in interpret mode), counts mapped back to index
    order through the layout's position map."""
    idx_kmers, shi, slo, sw, t_real, want = _bucket_world(3, 20000, 2000,
                                                          50)
    bidx = build_bucketed_index(*from_u64_np(idx_kmers), 50)
    ref = bucket_join_counts(bidx, shi, slo, sw, t_real, interpret=True)
    dk, dw = bucket_fill(_keys(shi, slo), _t(sw), 0, width=bidx.width,
                         B=bidx.n_buckets, CS=sample_cs(t_real,
                                                        bidx.n_buckets))
    grid = join_counts(_keys(bidx.hi, bidx.lo), dk, dw).numpy()
    got = np.zeros(bidx.m, np.int32)
    live = bidx.pos >= 0
    got[bidx.pos[live]] = grid[live]
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, want)


def test_join_counts_tiled_matches_xla():
    ihi, ilo, gid, dh, dl, dw, G, nt, tile = _tiled_cells(0)
    want = _join_xla_tiled(ihi, ilo, dh, dl, dw, nt=nt, tile=tile)
    got = join_counts(_keys(ihi, ilo), _keys(dh, dl), _t(dw), nt=nt,
                      tile=tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pair(keys):
    u = np.asarray(keys).view(np.uint64)
    return (jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


@pytest.mark.parametrize("nt,tile,ov,cs_t", [
    (4, 64, 64, 40), (4, 16, 18, 5), (1, 0, 136, 12)])
def test_join_pad_key_contract_matches_pallas(nt, tile, ov, cs_t,
                                              monkeypatch):
    """The contract the card's compare kernel keeps, pinned against the
    Pallas kernels in interpret mode on inputs that defeat unsafe
    shortcuts: index pad slots (key -1) with gids below G take live codes
    from lanes of key -1 and weight > 0, and zero-weight lanes, empty lane
    groups and overflow columns far past their share change nothing."""
    monkeypatch.setattr(jgr, "_CODES_INTERPRET", True)
    G = 9
    keys, gid, dk, dw = _adversarial_join(nt + tile + 1, 1, nt, tile, ov,
                                          cs_t)
    jargs = (*_pair(keys), jnp.asarray(gid), *_pair(dk[0]),
             jnp.asarray(dw[0]))
    pargs = (torch.from_numpy(keys), torch.from_numpy(gid),
             torch.from_numpy(dk[0]), torch.from_numpy(dw[0]))
    want = jgr._codes_from_buckets(*jargs, G=G, H=jgr.HIST_H, nt=nt,
                                   tile=tile)
    got = join_codes(*pargs, G=G, nt=nt, tile=tile)
    np.testing.assert_array_equal(got.numpy(), _codes_i32(want))
    assert int((got[torch.from_numpy(keys) == -1] != -1).sum()) > 0
    want, want_nl = jgr._codes_from_buckets_compact(
        *jargs, G=G, H=jgr.HIST_H, CAPR=8, nt=nt, tile=tile)
    got, got_nl = join_codes_compact(*pargs, G=G, CAPR=8, nt=nt, tile=tile)
    np.testing.assert_array_equal(got.numpy(), _codes_i32(want))
    assert int(got_nl) == int(want_nl) > int((got != -1).sum())


# join.cu's launch plan at the main paths' shapes: CI = 1,152 (nt = 4 tiles
# of 256, 128 overflow columns) in grange
_MAIN_SHAPES = [
    (1, 1152, 64, 4, 256, bj._MODE_COMPACT),   # B2: sample.sylsp, CS 16
    (1, 1152, 160, 4, 256, bj._MODE_CODES),    # B4: deep.sylsp, CS 40
    (1, 1152, 64, 1, 0, bj._MODE_COUNTS),      # B5: flat cells at 4x CS
    (1, 128, 256, 1, 0, bj._MODE_COUNTS),      # B5': the bucket regime
]


@pytest.mark.parametrize("S,CI,LW,nt,tile,mode", _MAIN_SHAPES + [
    (3, 1152, 144, 4, 256, bj._MODE_COMPACT),  # B2b: the cohort of three
    (5, 136, 2048, 1, 0, bj._MODE_CODES),      # samples in groups
    (1, 136, 8192, 1, 0, bj._MODE_COMPACT),    # the widest row
    (2, 82, 20, 4, 16, bj._MODE_COUNTS)])      # a CTA past the tiles too
def test_join_plan_fits_every_sample_group(S, CI, LW, nt, tile, mode):
    """Every sample in one group; a ring buffer holds a row of every
    sample of a group in either lane-list layout (a list a group, or one
    of every lane), as join_launch requires; the CTA within 227 KB; the
    column groups cover CI."""
    plan = bj.join_plan(S, CI, LW, nt, tile, mode)
    assert plan.smem <= 227 * 1024
    groups = [range(z * plan.SG, min(S, (z + 1) * plan.SG))
              for z in range(plan.n_sample_groups)]
    assert [s for g in groups for s in g] == list(range(S))
    cs = LW // nt
    assert plan.SG * nt * (cs + cs % 2) <= plan.lane_buf
    assert plan.SG * (LW + LW % 2) <= plan.lane_buf
    assert plan.list_cap >= plan.lane_buf // (cs + cs % 2)
    assert plan.n_col_groups * 128 >= CI > (plan.n_col_groups - 1) * 128


@pytest.mark.parametrize("S,CI,LW,nt,tile,mode", _MAIN_SHAPES)
def test_join_plan_main_paths_keep_32_warps(S, CI, LW, nt, tile, mode):
    """At the main paths' shapes a CTA's shared memory (with the 1 KB the
    card reserves a CTA, and 64 B of static arrays) lets 16 CTAs of 64
    threads, 32 warps, reside in the H100 SM's 228 KB."""
    plan = bj.join_plan(S, CI, LW, nt, tile, mode)
    assert 16 * (plan.smem + 1024 + 64) <= 228 * 1024


@pytest.mark.parametrize("S,CI,LW,nt,tile", [
    (1, 128, 8200, 1, 0),                  # past 8,192 lanes a row
    (1, 128, 12, 5, 8),                    # LW % nt != 0
    (1, 1 << 20, 8192, 8192, 64),          # 8,192 one-lane groups
    (1, 95, 8, 1, 0),                      # odd column count
    (1, 4 * 17 + 28, 20, 4, 17)])          # odd tile
def test_join_plan_rejects_what_the_kernel_cannot_take(S, CI, LW, nt, tile):
    with pytest.raises(ValueError):
        bj.join_plan(S, CI, LW, nt, tile, bj._MODE_COMPACT)


# ---- B1's launch plan ------------------------------------------------------

_FILL_SHAPES = [                # (P, NC, CS) -> cells a block
    (253_952, 131_072, 16, 128),          # grange chunk, sample.sylsp
    (1_523_712, 131_072, 36, 56),         # grange chunk, deep.sylsp
    (8_388_608, 65_536, 256, 8),          # whole range (B5''s fill)
    (253_952, 131_072, 64, 32),           # the lossless redo at 4x CS
]


@pytest.mark.parametrize("P,NC,CS,cpb", _FILL_SHAPES)
def test_fill_plan_main_paths(P, NC, CS, cpb):
    """At the main paths' shapes a block stages about 2,048 slots (24 KB),
    so 8 blocks fit the H100 SM's 228 KB; cells a block are a multiple of
    4, so every region starts on 16 bytes."""
    assert bf.fill_plan(P, NC, CS) == cpb
    assert 8 * (cpb * CS * 12 + cpb * 8 + 1024 + 128) <= 228 * 1024


@pytest.mark.parametrize("P,NC,CS", [
    (0, 0, 1), (0, 5, 3), (10, 1, 1), (100_000, 7, 5), (10**7, 301, 16),
    (18_777, 1204, 3), (5, 10**6, 1), (1000, 12, 19_000),
    (1000, 12, 19_363)])
def test_fill_plan_covers_the_cells(P, NC, CS):
    """Any geometry: at least one cell a block, at most NC (where NC > 0),
    a multiple of 4 from 4 up, at most about 1,024 entries a block where
    cells are dense, and the shared memory the kernel lays out for them
    (csrc/fill.cu's smem_need) within 227 KB."""
    cpb = bf.fill_plan(P, NC, CS)
    assert cpb >= 1
    assert NC == 0 or cpb <= NC
    assert cpb < 4 or cpb % 4 == 0
    assert cpb == 1 or P <= NC or cpb * P / NC <= 1024
    slots = cpb * CS
    assert (slots + slots % 2) * 8 + -(-slots // 4) * 16 + cpb * 8 \
        <= 232448 - 64


@pytest.mark.parametrize("P,NC,CS", [(10, 4, 0), (10, -1, 4),
                                     (-1, 4, 4), (10, 4, 19_364),
                                     (10, 4, 19_400)])
def test_fill_plan_rejects_what_the_kernel_cannot_take(P, NC, CS):
    """No cell capacity, negative sizes, or one cell's CS slots past 227 KB
    of shared memory (less the kernel's 64 B of static arrays)."""
    with pytest.raises(ValueError):
        bf.fill_plan(P, NC, CS)


# ---- B3: code-stream repack ------------------------------------------------

@pytest.mark.parametrize("row,width,plan", [
    (8192, 4, (1, 8192)),        # B3's first pass at the grange chunk
    (32768, 8, (8, 4096)),       # B8's at a [65,536, 256] read batch
    (24576, 4, (4, 6144)),       # three pieces' worth: a cluster of 4
    (131072, 4, (8, 8192)),      # past 8 pieces: rounds of 8
    (640, 8, (1, 640)), (128, 4, (1, 128))])   # B11/B12's 128-lane rows
def test_repack_plan(row, width, plan):
    """csrc/repack.cu's launch plan: a power-of-two cluster of at most 8
    CTAs a window, pieces of at most 32 KB in 128-slot multiples that
    cover the window, in rounds where 8 pieces do not."""
    c, piece = bf.repack_plan(row, width)
    assert (c, piece) == plan
    assert piece % 128 == 0 and piece * width <= 32768
    rounds = -(-row // (c * piece))
    assert (rounds - 1) * c * piece < row <= rounds * c * piece
    for bad in (0, 100, 200):
        with pytest.raises(ValueError):
            bf.repack_plan(bad, width)


@pytest.mark.parametrize("seed,n,row,cap,dens", [
    (0, 40_000, 4096, 512, 0.02), (1, 9_000, 1024, 256, 0.1),
    (3, 9_000, 1024, 256, 0.4),             # windows overflow cap
    (4, 70_000, 16384, 512, 0.01),          # a wide window, as the chain's
    (5, 300, 1024, 256, 0.3),               # n < row
    (6, 0, 1024, 256, 0.1),                 # n = 0
])
def test_repack_matches_pallas(seed, n, row, cap, dens):
    """B3's plain version against repack1_flat in interpret mode. An empty
    stream has no window: the port returns no slot, and the Pallas call,
    whose grid would have no step, refuses it."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 2**31, size=n, dtype=np.uint32)
    v[rng.random(n) > dens] = SENT
    got = repack1_flat(torch.from_numpy(v.view(np.int32)), row=row, cap=cap)
    if n == 0:
        assert got.shape == (0,)
        with pytest.raises(TypeError):
            j_repack1_flat(jnp.asarray(v), row=row, cap=cap, interpret=True)
        return
    want = j_repack1_flat(jnp.asarray(v), row=row, cap=cap, interpret=True)
    np.testing.assert_array_equal(got.numpy(), _codes_i32(want))
    if dens > 0.3:                          # overflow is a visible drop
        assert int((got != -1).sum()) < int((v != SENT).sum())


@pytest.mark.parametrize("seed,n,row,cap,dens", [
    (0, 70_000, 16384, 512, 0.01),          # a wide window
    (1, 9_000, 1024, 256, 0.1),
    (2, 9_000, 1024, 256, 0.4),             # windows overflow cap
    (3, 300, 1024, 256, 0.3),               # n < row
    (4, 0, 1024, 256, 0.1),                 # n = 0
])
def test_repack2_matches_pallas(seed, n, row, cap, dens):
    """B8's plain version (int64 keys, pad -1) against repack2_flat's (hi,
    lo) pair streams in interpret mode, dead slots (SENT, SENT) as on every
    stream at c >= 2; an empty stream as in test_repack_matches_pallas."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**31, size=n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    dead = rng.random(n) > dens
    hi[dead] = SENT
    lo[dead] = SENT
    got = bf.repack2_flat(_keys(hi, lo), row=row, cap=cap)
    if n == 0:
        assert got.shape == (0,)
        with pytest.raises(TypeError):
            j_repack2_flat(jnp.asarray(hi), jnp.asarray(lo), row=row,
                           cap=cap, interpret=True)
        return
    wh, wl = j_repack2_flat(jnp.asarray(hi), jnp.asarray(lo), row=row,
                            cap=cap, interpret=True)
    np.testing.assert_array_equal(got.numpy(), _keys(wh, wl).numpy())
    kept = int((got != -1).sum())
    assert (kept < int((~dead).sum())) == (dens > 0.3)
