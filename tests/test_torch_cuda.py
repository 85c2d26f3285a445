"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither jax nor sylph_tpu, so it also runs on a machine
without JAX; tests/conftest.py imports jax, hence on such a machine:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Outputs must be bit-identical to the plain versions (integer kernels).
"""

import threading

import numpy as np
import pytest
import torch

from sylph_tpu_torch.engine import device_sketch as ds
from sylph_tpu_torch.gpu import bucket_fill as bf
from sylph_tpu_torch.gpu import bucket_join as bj
from sylph_tpu_torch.gpu import grange as gr
from sylph_tpu_torch.gpu import seeding as sd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())


def _slice(seed, P, B, width, base, n_live):
    """Sorted int64 sample slice with zero weights, hashes below ``base``
    and past the last bucket, and KEY_PAD tail (the engine's _pad_slice)."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(base - 3 * width, base + (B + 2) * width, size=n_live)
    lo = rng.integers(0, 2**32, size=n_live)
    keys = np.sort(np.unique((hi.astype(np.int64) << 32) | lo))
    w = rng.integers(0, 6, size=keys.size).astype(np.int32)   # 0 = folded
    k = np.full(P, -1, np.int64)
    ww = np.zeros(P, np.int32)
    k[:keys.size], ww[:keys.size] = keys, w
    return torch.from_numpy(k), torch.from_numpy(ww)


@pytest.mark.parametrize("B,nt,CS,n_live", [
    (512, 1, 8, 3000), (128, 4, 4, 3000), (64, 1, 2, 4000), (300, 4, 3, 0)])
def test_fill_matches_plain(cuda, B, nt, CS, n_live):
    width, base = 64, 1 << 20
    k, w = _slice(B + nt, 8192, B, width, base, n_live)
    kw = dict(width=width, B=B, CS=CS, nt=nt,
              subwidth=-(-width // nt) if nt > 1 else 0)
    got = bf.bucket_fill(k.to(cuda), w.to(cuda), base, **kw)
    want = bj._sample_to_buckets(k, w, base=base, **kw)
    _equal(got, want)


def _index(seed, B, CI, G, base, width, nt=1):
    rng = np.random.default_rng(seed)
    hi = base + rng.integers(0, width, size=(B, CI)) + np.arange(B)[:, None] \
        * width
    keys = (hi.astype(np.int64) << 32) | rng.integers(0, 2**32, size=(B, CI))
    keys[rng.random((B, CI)) < 0.3] = -1
    gid = rng.integers(0, G + 2, size=(B, CI)).astype(np.int32)
    return torch.from_numpy(keys), torch.from_numpy(gid)


def _cells(ikey, seed, LW):
    """[B, LW] sample lanes: about half the lanes copy an index key."""
    rng = np.random.default_rng(seed)
    B, CI = ikey.shape
    pick = rng.integers(0, CI, size=(B, LW))
    dk = torch.gather(ikey, 1, torch.from_numpy(pick))
    fresh = torch.from_numpy(rng.random((B, LW)) < 0.5)
    dk = torch.where(fresh, torch.from_numpy(
        rng.integers(0, 2**62, size=(B, LW))), dk)
    dw = torch.from_numpy(rng.integers(0, 90, size=(B, LW)).astype(np.int32))
    return dk, dw


@pytest.mark.parametrize("B,CI,LW,nt,tile,capr", [
    (256, 136, 8, 1, 0, 16), (128, 64 + 16, 12, 4, 16, 8),
    (100, 40, 8, 1, 0, 1),             # B % 64 != 0: one-row blocks
    (128, 136, 64, 1, 0, 16),          # 48 KB of staged lanes
    (128, 1024 + 128, 160, 4, 256, 24)])   # past 48 KB: the opt-in
def test_join_modes_match_plain(cuda, B, CI, LW, nt, tile, capr):
    G = 9
    ikey, gid = _index(B + CI, B, CI, G, 1 << 20, 64)
    dk, dw = _cells(ikey, B, LW)
    dev = [t.to(cuda) for t in (ikey, gid, dk, dw)]
    kw = dict(nt=nt, tile=tile)
    _equal((bj.join_counts(dev[0], dev[2], dev[3], **kw),),
           (bj.join_counts_plain(ikey, dk, dw, **kw),))
    _equal((bj.join_codes(*dev, G=G, **kw),),
           (bj.join_codes_plain(ikey, gid, dk, dw, G=G, **kw),))
    got = bj.join_codes_compact(*dev, G=G, CAPR=capr, **kw)
    want = bj.join_codes_compact_plain(ikey, gid, dk, dw, G=G, CAPR=capr,
                                       **kw)
    _equal((got[0],), (want[0],))
    assert int(got[1]) == int(want[1]) > 0


def test_join_shared_memory_sizes_in_turn(cuda):
    """Launches whose staged lanes need 48 KB, then more (the opt-in),
    then a different amount past 48 KB, as a sparse then a dense sample
    drive one engine."""
    B, CI, G = 128, 136, 9
    ikey, gid = _index(7, B, CI, G, 1 << 20, 64)
    dev = [t.to(cuda) for t in (ikey, gid)]
    for LW in (64, 160, 300, 64):
        dk, dw = _cells(ikey, LW, LW)
        got = bj.join_codes_compact(*dev, dk.to(cuda), dw.to(cuda), G=G,
                                    CAPR=16)
        want = bj.join_codes_compact_plain(ikey, gid, dk, dw, G=G, CAPR=16)
        _equal((got[0],), (want[0],))
        assert int(got[1]) == int(want[1]) > 0


@pytest.mark.parametrize("S", [1, 2, 5])
@pytest.mark.parametrize("B,CI,LW,nt,tile,capr", [
    (128, 136, 8, 1, 0, 16), (128, 64 + 16, 12, 4, 16, 8),
    (100, 40, 8, 1, 0, 1),             # B % 64 != 0: one-row blocks
    (64, 136, 2048, 1, 0, 16),         # S*LW past the 8,192-lane stage at
    (64, 1024 + 128, 2048, 4, 256, 24),   # S = 5: the samples in groups
    (64, 136, 8192, 1, 0, 16)])        # one sample, one row per stage
def test_join_batched_modes_match_plain(cuda, S, B, CI, LW, nt, tile, capr):
    """B5b, B4b and B2b against their plain versions, lane widths on both
    sides of the shared-memory stage; at S = 1 equal to B5, B4 and B2."""
    G = 9
    ikey, gid = _index(B + CI, B, CI, G, 1 << 20, 64)
    cells = [_cells(ikey, B + s, LW) for s in range(S)]
    dk = torch.stack([k for k, _ in cells])
    dw = torch.stack([w for _, w in cells])
    dev = [t.to(cuda) for t in (ikey, gid, dk, dw)]
    kw = dict(nt=nt, tile=tile)
    got_c = bj.join_counts_batched(dev[0], dev[2], dev[3], **kw)
    _equal((got_c,), (bj.join_counts_batched_plain(ikey, dk, dw, **kw),))
    got_x = bj.join_codes_batched(*dev, G=G, **kw)
    _equal((got_x,), (bj.join_codes_batched_plain(ikey, gid, dk, dw, G=G,
                                                  **kw),))
    got = bj.join_codes_compact_batched(*dev, G=G, CAPR=capr, **kw)
    want = bj.join_codes_compact_batched_plain(ikey, gid, dk, dw, G=G,
                                               CAPR=capr, **kw)
    _equal((got[0],), (want[0],))
    assert int(got[1]) == int(want[1]) > 0
    if S == 1:
        _equal((got_c[0], got_x[0]),
               (bj.join_counts(dev[0], dev[2][0], dev[3][0], **kw),
                bj.join_codes(dev[0], dev[1], dev[2][0], dev[3][0], G=G,
                              **kw)))
        one = bj.join_codes_compact(dev[0], dev[1], dev[2][0], dev[3][0],
                                    G=G, CAPR=capr, **kw)
        _equal((got[0][0],), (one[0],))
        assert int(one[1]) == int(got[1])


def _main_geometry(seed, B, CS, S, nt=4, tile=256, ov=128, G=9):
    """A chunk at the main path's column geometry (nt tiles of 256 slots
    and 128 overflow columns): each tile holds its cell's sorted keys, 90-
    100% full, the overflow region up to 30 keys at its start, pads -1 with
    gid G; S samples' [B, nt*CS] cell grids filled as B1 fills them, about
    CS/4 live lanes a cell, half of them index keys."""
    rng = np.random.default_rng(seed)
    width, base = 1 << 16, 1 << 20
    subw = width // nt
    CI = nt * tile + ov
    keys = np.full((B, CI), -1, np.int64)
    for b in range(B):
        for t in range(nt):
            n = int(rng.integers(tile * 9 // 10, tile + 1))
            hi = base + b * width + t * subw + rng.integers(0, subw, size=n)
            keys[b, t * tile:t * tile + n] = np.sort(
                (hi << 32) | rng.integers(0, 2**32, size=n))
        n = int(rng.integers(0, 30))
        hi = base + b * width + rng.integers(0, width, size=n)
        keys[b, nt * tile:nt * tile + n] = (hi << 32) | rng.integers(
            0, 2**32, size=n)
    gid = np.full((B, CI), G, np.int32)
    live = keys != -1
    gid[live] = rng.integers(0, G, size=int(live.sum()))
    ikey = torch.from_numpy(keys)
    n_smp = B * nt * CS // 4
    dks, dws = [], []
    for _ in range(S):
        own = rng.choice(keys[live], size=n_smp // 2, replace=False)
        hi = base + rng.integers(0, B * width, size=n_smp - own.size)
        sk = np.unique(np.concatenate([own, (hi << 32) | rng.integers(
            0, 2**32, size=hi.size)]))
        sw = rng.integers(1, 90, size=sk.size).astype(np.int32)
        dk, dw = bj._sample_to_buckets(
            torch.from_numpy(sk), torch.from_numpy(sw), width=width, B=B,
            CS=CS, base=base, nt=nt, subwidth=subw)
        dks.append(dk.view(B, nt * CS))
        dws.append(dw.view(B, nt * CS))
    return ikey, torch.from_numpy(gid), torch.stack(dks), torch.stack(dws)


def _adversarial_join(seed, S, nt, tile, ov, cs_t, B=128, G=9):
    """Inputs that defeat unsafe shortcuts of the compare kernel: index pad
    slots (key -1) with gids below G; in a fifth of the rows a lane of key
    -1 and weight > 0 (elsewhere key -1 lanes weigh 0, as the fill's pads
    do); zero weights between live lanes, on keys that match; a lane group
    emptied in some rows; overflow columns all live in a quarter of the
    rows, far past their share. -> ikey [B, CI] int64, gid [B, CI] int32,
    dk [S, B, nt*cs_t] int64, dw int32 (nt = 1: CI = ov, one group)."""
    rng = np.random.default_rng(seed)
    CI = nt * tile + ov if nt > 1 else ov
    t0 = nt * tile if nt > 1 else 0            # first overflow column
    keys = rng.integers(0, 2**62, size=(B, CI))
    pad = rng.random((B, CI)) < 0.3
    full_ov = rng.random(B) < 0.25
    pad[:, t0:] = (rng.random((B, CI - t0)) < 0.9) & ~full_ov[:, None]
    keys[pad] = -1
    gid = rng.integers(0, G + 2, size=(B, CI)).astype(np.int32)
    LW = nt * cs_t
    dk = np.empty((S, B, LW), np.int64)
    dw = rng.integers(1, 90, size=(S, B, LW)).astype(np.int32)
    rows = np.arange(B)[:, None]
    for s in range(S):
        for g in range(nt):
            lanes = slice(g * cs_t, (g + 1) * cs_t)
            col = np.where(rng.random((B, cs_t)) < 0.5,
                           g * tile + rng.integers(0, max(tile, 1),
                                                   size=(B, cs_t)),
                           t0 + rng.integers(0, CI - t0, size=(B, cs_t)))
            col = col if nt > 1 else t0 + rng.integers(0, CI, (B, cs_t))
            dk[s, :, lanes] = keys[rows, col]
        fresh = rng.random((B, LW)) < 0.3
        dk[s][fresh] = rng.integers(0, 2**62, size=int(fresh.sum()))
        dw[s][rng.random((B, LW)) < 0.4] = 0
        dw[s][dk[s] == -1] = 0
        neg = np.flatnonzero(rng.random(B) < 0.2)
        lane = rng.integers(0, LW, size=neg.size)
        dk[s, neg, lane] = -1
        dw[s, neg, lane] = rng.integers(1, 90, size=neg.size)
        empty = np.flatnonzero(rng.random(B) < 0.15)
        for r, g in zip(empty, rng.integers(0, nt, size=empty.size)):
            dw[s, r, g * cs_t:(g + 1) * cs_t] = 0
    return keys, gid, dk, dw


def _join_all_modes(cuda, ikey, gid, dk, dw, *, G, capr, nt, tile):
    """Every mode of join.cu against its plain version: the batched modes
    over all of dk's samples, the single-sample ones at S = 1."""
    dev = [t.to(cuda) for t in (ikey, gid, dk, dw)]
    kw = dict(nt=nt, tile=tile)
    _equal((bj.join_counts_batched(dev[0], dev[2], dev[3], **kw),),
           (bj.join_counts_batched_plain(ikey, dk, dw, **kw),))
    _equal((bj.join_codes_batched(*dev, G=G, **kw),),
           (bj.join_codes_batched_plain(ikey, gid, dk, dw, G=G, **kw),))
    got = bj.join_codes_compact_batched(*dev, G=G, CAPR=capr, **kw)
    want = bj.join_codes_compact_batched_plain(ikey, gid, dk, dw, G=G,
                                               CAPR=capr, **kw)
    _equal((got[0],), (want[0],))
    assert int(got[1]) == int(want[1]) > 0
    if dk.shape[0] == 1:
        _equal((bj.join_counts(dev[0], dev[2][0], dev[3][0], **kw),
                bj.join_codes(dev[0], dev[1], dev[2][0], dev[3][0], G=G,
                              **kw)),
               (bj.join_counts_plain(ikey, dk[0], dw[0], **kw),
                bj.join_codes_plain(ikey, gid, dk[0], dw[0], G=G, **kw)))
        one = bj.join_codes_compact(dev[0], dev[1], dev[2][0], dev[3][0],
                                    G=G, CAPR=capr, **kw)
        _equal(one, bj.join_codes_compact_plain(ikey, gid, dk[0], dw[0],
                                                G=G, CAPR=capr, **kw))
    return want


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("CS", [16, 40])
def test_join_main_geometry_matches_plain(cuda, S, CS):
    """B = 128 rows at the GTDB-scale chunk's columns (CI = 1,152: nt = 4
    tiles of 256 and 128 overflow columns), cells from the fill at B2's
    and B4's lane capacities, CAPR = 24: every mode, bit for bit."""
    ikey, gid, dk, dw = _main_geometry(CS + S, 128, CS, S)
    assert ikey.shape == (128, 1152) and dk.shape == (S, 128, 4 * CS)
    _join_all_modes(cuda, ikey, gid, dk, dw, G=9, capr=24, nt=4, tile=256)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("nt,tile,ov,cs_t", [
    (4, 64, 64, 40),                   # warp-uniform groups, two chunks
    (4, 16, 18, 5),                    # a CTA past the tiles too; odd lists
    (1, 0, 136, 12)])                  # flat: every column sees every lane
def test_join_adversarial_matches_plain(cuda, S, nt, tile, ov, cs_t):
    """Pad slots with gids below G against live lanes of key -1, zero
    weights between live lanes, empty lane groups and overflow columns far
    fuller than their share: every mode, bit for bit."""
    keys, gid, dk, dw = _adversarial_join(nt + tile + S, S, nt, tile, ov,
                                          cs_t)
    want = _join_all_modes(cuda, torch.from_numpy(keys),
                           torch.from_numpy(gid), torch.from_numpy(dk),
                           torch.from_numpy(dw), G=9, capr=8, nt=nt,
                           tile=tile)
    # pad slots coded live: the -1 lanes were seen
    codes = bj.join_codes_batched_plain(
        torch.from_numpy(keys), torch.from_numpy(gid), torch.from_numpy(dk),
        torch.from_numpy(dw), G=9, nt=nt, tile=tile)
    assert int((codes[:, torch.from_numpy(keys) == -1] != -1).sum()) > 0
    assert int(want[1]) > int((want[0] != -1).sum())   # CAPR overflowed


def test_join_rejects_odd_geometry_and_unaligned_keys(cuda):
    """The compare kernel loads a thread's two columns as one 16-byte pair:
    an odd column count, an odd tile or a key grid off 16 bytes raises,
    with no launch, where the plain version on the CPU takes them."""
    keys, gid, dk, dw = _adversarial_join(3, 1, 4, 17, 27, 5)
    ikey, gid, dk, dw = (torch.from_numpy(t) for t in (keys, gid, dk, dw))
    dev = [t.to(cuda) for t in (ikey, gid, dk[0], dw[0])]
    n0 = dict(bj._cuda.LAUNCHES)
    for nt, tile in ((4, 17), (1, 0)):            # odd tile; odd CI = 95
        with pytest.raises(ValueError):
            bj.join_counts(dev[0], dev[2], dev[3], nt=nt, tile=tile)
        with pytest.raises(ValueError):
            bj.join_codes(*dev, G=9, nt=nt, tile=tile)
        with pytest.raises(ValueError):
            bj.join_codes_compact(*dev, G=9, CAPR=8, nt=nt, tile=tile)
        bj.join_codes_compact(ikey, gid, dk[0], dw[0], G=9, CAPR=8, nt=nt,
                              tile=tile)
    flat = torch.zeros(1 + 64 * 96, dtype=torch.int64, device=cuda)
    off = flat[1:].view(64, 96)                   # 8 bytes past alignment
    with pytest.raises(ValueError):
        bj.join_counts(off, torch.zeros((64, 8), dtype=torch.int64,
                                        device=cuda),
                       torch.ones((64, 8), dtype=torch.int32, device=cuda))
    assert dict(bj._cuda.LAUNCHES) == n0


def test_join_compact_overflow_detected_on_card(cuda):
    """B2's conservation check on the card: CAPR outside [1, TB] raises,
    and a block whose columns hold more live codes than CAPR keeps CAPR of
    them while n_live counts all (n_live != n_compacted)."""
    B, CI, G = 64, 128, 3
    ikey = torch.arange(B * CI, dtype=torch.int64).view(B, CI) + 7
    gid = torch.ones((B, CI), dtype=torch.int32)
    dk = ikey[:, :4].contiguous()
    dw = torch.ones((B, 4), dtype=torch.int32)
    dev = [t.to(cuda) for t in (ikey, gid, dk, dw)]
    for capr in (0, 65):
        with pytest.raises(ValueError):
            bj.join_codes_compact(*dev, G=G, CAPR=capr)
    got = bj.join_codes_compact(*dev, G=G, CAPR=24)
    _equal(got, bj.join_codes_compact_plain(ikey, gid, dk, dw, G=G,
                                            CAPR=24))
    assert int(got[1]) == B * 4 and int((got[0] != -1).sum()) == 4 * 24


@pytest.mark.parametrize("nt", [1, 4])
def test_engine_hists_batched_on_card_matches_cpu(cuda, nt):
    """The batched grange sweep on the card (B1 fills, B2b, B3) equals the
    CPU's, through one B2b launch per chunk and no per-sample sweep."""
    rng = np.random.default_rng(40 + nt)
    G, m = 50, 120_000
    thr = ((1 << 64) - 1) // 20
    kmers = rng.integers(0, thr, size=m, dtype=np.uint64)
    gids = rng.integers(0, G, size=m).astype(np.int32)
    tables = []
    for n in (3000, 0, 5000, 1200):
        sk = np.unique(np.concatenate([rng.choice(kmers, size=n // 2),
                                       rng.integers(0, thr, size=n - n // 2,
                                                    dtype=np.uint64)]))
        tables.append((sk, rng.integers(1, 90, size=sk.size).astype(
            np.uint32)))
    idx = gr.build_grange_index(kmers, gids, G, chunk_slots=1 << 15,
                                target_mean=512 if nt > 1 else 64, nt=nt,
                                device=cuda)
    on_cpu = gr.GRangeEngine(idx, device="cpu")
    on_card = gr.GRangeEngine(idx, device=cuda)
    want = on_cpu.hists_batched(tables)
    n0 = bj._cuda.LAUNCHES["B2b_join_codes_compact_batched"]
    got = on_card.hists_batched(tables)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0
    assert on_card.counters == on_cpu.counters
    assert on_card.counters["hists_sweeps"] == 0
    assert (bj._cuda.LAUNCHES["B2b_join_codes_compact_batched"] - n0
            == len(idx.chunk_keys))


@pytest.mark.parametrize("n,row,cap,dens", [
    (40_000, 4096, 512, 0.02), (9_000, 1024, 256, 0.4), (100, 1024, 256,
                                                          0.5)])
def test_repack_matches_plain(cuda, n, row, cap, dens):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**31, size=n).astype(np.int32)
    v[rng.random(n) > dens] = -1
    v = torch.from_numpy(v)
    got = bf.repack1_flat(v.to(cuda), row=row, cap=cap)
    _equal((got,), (bf.repack1_flat_plain(v, row=row, cap=cap),))


@pytest.mark.parametrize("n,row,cap,dens", [
    (2_200_000, 16384, 768, 0.034), (9_000, 1024, 256, 0.4),
    (100, 1024, 256, 0.5)])
def test_repack2_matches_plain(cuda, n, row, cap, dens):
    """B8: the int64 instance of the repack template, with overflowing
    windows at the 0.4 density."""
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**62, size=n, dtype=np.int64)
    v[rng.random(n) > dens] = -1
    v = torch.from_numpy(v)
    got = bf.repack2_flat(v.to(cuda), row=row, cap=cap)
    _equal((got,), (bf.repack2_flat_plain(v, row=row, cap=cap),))


def _packed_batch(seed, N, L):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, size=N).astype(np.int32)
    lens[:3] = (L, 0, 20)
    packed = torch.from_numpy(ds._pack16_rows(bases).view(np.int32))
    return packed, torch.from_numpy(lens)


@pytest.mark.parametrize("N,L,c,k", [
    (256, 256, 200, 31), (300, 128, 5, 21), (64, 512, 7, 16),
    (40, 256, 3, 9), (8, 128, 1, 31)])
def test_seed_matches_plain(cuda, N, L, c, k):
    """B7 against its plain version: every hash (windows past L read
    zeros in both) and every keep, bit for bit."""
    packed, lens = _packed_batch(N + k, N, L)
    got = sd.seed_packed(packed.to(cuda), lens.to(cuda), c=c, k=k)
    want = sd.seed_packed_plain(packed, lens, c=c, k=k)
    _equal(got, want)
    assert int(want[1].sum()) > 0


def test_seed_concurrent_threads(cuda):
    """B7 launched from two host threads at once (the ingest's worker
    pool does so) gives each thread its own right answer."""
    batches = [_packed_batch(s, 2048, 256) for s in (1, 2)]
    want = [sd.seed_packed_plain(p, n, c=50, k=31) for p, n in batches]
    got = [None, None]

    def run(i):
        p, n = batches[i]
        for _ in range(20):
            got[i] = sd.seed_packed(p.to(cuda), n.to(cuda), c=50, k=31)
        torch.cuda.synchronize()

    ths = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in ths)
    for g, w in zip(got, want):
        _equal(g, w)


def test_wrappers_reject_bad_inputs(cuda):
    k = torch.zeros(16, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        bf.bucket_fill(k, torch.zeros(16, dtype=torch.int64, device=cuda),
                       0, width=4, B=4, CS=2)
    with pytest.raises(ValueError):
        bf.repack1_flat(k, row=1024, cap=256)
    ikey = torch.zeros((4, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        bj.join_counts(ikey, torch.zeros((4, 8), dtype=torch.int64),
                       torch.zeros((4, 8), dtype=torch.int32, device=cuda))
    n0 = bj._cuda.LAUNCHES["B5_join_counts"]
    for LW, nt in ((8200, 1), (12, 5)):   # past 8,192 lanes; LW % nt != 0
        with pytest.raises(ValueError):
            bj.join_counts(ikey, torch.zeros((4, LW), dtype=torch.int64,
                                             device=cuda),
                           torch.zeros((4, LW), dtype=torch.int32,
                                       device=cuda), nt=nt, tile=1)
    assert bj._cuda.LAUNCHES["B5_join_counts"] == n0
    with pytest.raises(ValueError):
        bf.repack2_flat(torch.zeros(16, dtype=torch.int32, device=cuda),
                        row=1024, cap=256)
    with pytest.raises(ValueError):
        sd.seed_packed(torch.zeros((4, 8), dtype=torch.int64, device=cuda),
                       torch.zeros(4, dtype=torch.int32, device=cuda),
                       c=200, k=31)


@pytest.mark.parametrize("nt,ci_cap", [(1, None), (4, None), (1, 8)])
def test_engine_on_card_matches_cpu(cuda, nt, ci_cap):
    rng = np.random.default_rng(nt)
    G, m = 50, 120_000
    kmers = rng.integers(0, ((1 << 64) - 1) // 20, size=m, dtype=np.uint64)
    kmers[:m // 10] = rng.choice(kmers[m // 10:m // 5], size=m // 10)
    gids = rng.integers(0, G, size=m).astype(np.int32)
    sk = np.unique(np.concatenate([rng.choice(kmers, size=3000), rng.integers(
        0, ((1 << 64) - 1) // 20, size=3000, dtype=np.uint64)]))
    sc = rng.integers(1, 100, size=sk.size).astype(np.uint32)
    idx = gr.build_grange_index(kmers, gids, G, chunk_slots=1 << 15,
                                target_mean=512 if nt > 1 else 64, nt=nt,
                                ci_cap=ci_cap, device=cuda)
    want = gr.GRangeEngine(idx, device="cpu").hists(sk, sc)
    got = gr.GRangeEngine(idx, device=cuda).hists(sk, sc)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


# ---- the small-database regimes and genome seeding -------------------------

def _bucket_world(seed, n_slots, mean, c=200):
    """A bucketed chunk of n_slots - 100 live k-mers and a sorted sample
    table of mean * B entries (up to a quarter of them index k-mers), -1
    tail."""
    rng = np.random.default_rng(seed)
    thr = ((1 << 64) - 1) // c
    idx = rng.integers(0, thr, size=n_slots - 100, dtype=np.uint64)
    bidx = bj.build_bucketed_index(idx.view(np.int64), c, n_slots=n_slots)
    t = mean * bidx.n_buckets
    n_in = min(t // 4, idx.size)
    smp = np.unique(np.concatenate([rng.choice(idx, size=n_in,
                                               replace=False),
                                    rng.integers(0, thr, size=t - n_in,
                                                 dtype=np.uint64)]))
    keys = np.concatenate([smp.view(np.int64), np.full(333, -1, np.int64)])
    w = np.concatenate([rng.integers(1, 7, size=smp.size),
                        np.zeros(333, np.int64)]).astype(np.int32)
    return bidx, torch.from_numpy(keys), torch.from_numpy(w), smp.size


@pytest.mark.parametrize("n_slots,mean,cs", [
    (16384, 160, 256), (16384, 480, 640), (2048, 160, 256)])
def test_bucket_join_matches_plain(cuda, n_slots, mean, cs):
    """B5' (fill + compare) and its compare alone against the plain
    versions at 256 and 640 lanes, and at B = 32 < 64 (TB = B)."""
    bidx, keys, w, t = _bucket_world(n_slots + mean, n_slots, mean)
    B = bidx.n_buckets
    CS = bj.sample_cs(t, B)
    assert CS == cs and bj.block_rows(B) == min(B, 64)
    kw = dict(width=bidx.width, B=B, CS=CS)
    ikey = bidx.key
    want = bj.bucket_join_device(ikey, keys, w, **kw)
    n0 = bj._cuda.LAUNCHES["B5p_bucket_join"]
    got = bj.bucket_join_device(ikey.to(cuda), keys.to(cuda), w.to(cuda),
                                **kw)
    torch.cuda.synchronize()
    assert bj._cuda.LAUNCHES["B5p_bucket_join"] == n0 + 1
    _equal((got,), (want,))
    assert int((want > 0).sum()) > B
    dk, dw = bj._sample_to_buckets(keys, w, width=bidx.width, B=B, CS=CS)
    _equal((bj.bucket_counts(ikey.to(cuda), dk.to(cuda), dw.to(cuda)),),
           (bj.join_counts_plain(ikey, dk, dw),))


def test_fill_whole_range_matches_plain(cuda):
    """B1 at nt = 1, base 0, over a whole sample table: 4,096 buckets."""
    bidx, keys, w, t = _bucket_world(9, 1 << 18, 150)
    kw = dict(width=bidx.width, B=bidx.n_buckets,
              CS=bj.sample_cs(t, bidx.n_buckets))
    got = bf.bucket_fill(keys.to(cuda), w.to(cuda), 0, **kw)
    _equal(got, bj._sample_to_buckets(keys, w, base=0, **kw))


def test_seed_genome_rows_matches_plain(cuda):
    """B7 at the genome row length, L = 4096, and the whole genome
    seeding on the card against the native C seeder."""
    from sylph_tpu_torch.core.native_core import seed_positions_native
    from sylph_tpu_torch.io.fastx import ParsedFastx
    packed, lens = _packed_batch(5, 96, 4096)
    for c, k in ((200, 31), (25, 21)):
        _equal(sd.seed_packed(packed.to(cuda), lens.to(cuda), c=c, k=k),
               sd.seed_packed_plain(packed, lens, c=c, k=k))
    rng = np.random.default_rng(8)
    lens = np.array([20, 4096, 4097, 250_000, 31, 77_777])
    codes = rng.integers(0, 4, size=int(lens.sum())).astype(np.uint8)
    ends = np.cumsum(lens)
    px = ParsedFastx(codes, ends - lens, ends)
    for c, k in ((200, 31), (10, 31), (3, 15)):
        got = ds.genome_survivor_positions(px, c, k, cuda)
        want = seed_positions_native(codes, ends - lens, ends, c, k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("regime", ["merge", "bucket"])
def test_small_db_engine_on_card_matches_cpu(cuda, regime, monkeypatch):
    from sylph_tpu_torch.core.types import GenomeSketch, SequencesSketch
    from sylph_tpu_torch.engine.device_exec import DeviceContainment
    monkeypatch.setattr(DeviceContainment, "CHUNK", 1 << 15)
    if regime == "bucket":
        monkeypatch.setattr(DeviceContainment, "BUCKET_MIN", 1000)
    rng = np.random.default_rng(12)
    c = 50
    pool = rng.integers(0, ((1 << 64) - 1) // c, size=200_000,
                        dtype=np.uint64)
    gs = [GenomeSketch(rng.choice(pool, size=3000, replace=False), None,
                       f"g{i}", f"c{i}", c, 31, 1, 30) for i in range(40)]
    skm = rng.choice(pool, size=60_000, replace=False)
    sk = SequencesSketch(skm, rng.integers(1, 9, size=skm.size).astype(
        np.uint32), c, 31, "s", None, False, 150.0)
    on_cpu = DeviceContainment(gs, device="cpu")
    on_card = DeviceContainment(gs, device=cuda)
    assert on_card._use_buckets == (regime == "bucket")
    assert (len(on_card._bchunks) if regime == "bucket"
            else on_card._index_dev.numel() // (1 << 15)) == 4
    np.testing.assert_array_equal(on_card.hists(sk), on_cpu.hists(sk))
    for gi in range(0, 40, 7):
        a, b = on_card.genome_covs(gi, sk), on_cpu.genome_covs(gi, sk)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


# ---- the one-shot pipeline: B6, B9, B10 ------------------------------------

def _code_batch(seed, N, L, k):
    """Random reads; rows 0-3 of length L, 0, k - 1 and past L; rows 4-7
    ATAT... repeats, whose every 31-mer window hashes below u64::MAX / 9."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    bases[4:8] = np.resize(np.array([0, 3], np.uint8), L)
    lens = rng.integers(0, L + 1, size=N).astype(np.int32)
    lens[:8] = (L, 0, k - 1, L + 40, L, L, L, L)[:min(N, 8)]
    return torch.from_numpy(bases), torch.from_numpy(lens)


@pytest.mark.parametrize("N,L,c,k", [
    (512, 256, 200, 31), (100, 256, 20, 31), (256, 512, 2, 31),
    (8, 128, 5, 17), (1024, 384, 1, 24), (256, 256, 9, 31)])
def test_seed_pack_matches_plain(cuda, N, L, c, k):
    """B6 (at 128 lanes and at the pipeline's cap) and B10 against their
    plain versions: N below one 256-row block, more than 128 survivors a
    read (c = 2, c = 1, the ATAT reads at c = 9), lengths of 0, below k
    and past L."""
    from sylph_tpu_torch.gpu import seed_pack as sp
    bases, lens = _code_batch(N + L + k, N, L, k)
    bd, ld = bases.to(cuda), lens.to(cuda)
    _equal((sp.seed_pack(bd, ld, c=c, k=k),),
           (sp.seed_pack_plain(bases, lens, c=c, k=k),))
    cap = sp.compact_cap(L, c)
    _equal((sp.seed_pack(bd, ld, c=c, k=k, lanes=cap),),
           (sp.seed_pack_plain(bases, lens, c=c, k=k, lanes=cap),))
    _equal((sp.seed_compact(bd, ld, c=c, k=k),),
           (sp.seed_compact_plain(bases, lens, c=c, k=k),))
    if c <= 2 or c == 9:
        assert int((sp.seed_pack(bd, ld, c=c, k=k) != -1).sum(1).max()) \
            == 128


@pytest.mark.parametrize("k", [1, 9, 15])
def test_seed_compact_short_k_matches_plain(cuda, k):
    from sylph_tpu_torch.gpu import seed_pack as sp
    bases, lens = _code_batch(k, 300 - 44, 256, k)
    _equal((sp.seed_compact(bases.to(cuda), lens.to(cuda), c=7, k=k),),
           (sp.seed_compact_plain(bases, lens, c=7, k=k),))


@pytest.mark.parametrize("N,L,c,k", [
    (1024, 256, 200, 31), (100, 256, 20, 31), (64, 512, 2, 31),
    (64, 256, 9, 31), (8, 40, 3, 21)])
def test_seed_pack_t_matches_plain(cuda, N, L, c, k):
    """B9 against its plain version: N below one 512-column block, the
    ATAT reads past cap_rows (c = 9: 226 survivors, 128 rows), lengths of
    0, below k and past L."""
    from sylph_tpu_torch.gpu import seed_pack as sp
    bases, lens = _code_batch(N + L, N, L, k)
    bt = bases.t().contiguous()
    got = sp.seed_pack_t(bt.to(cuda), lens.to(cuda), c=c, k=k)
    _equal((got,), (sp.seed_pack_t_plain(bt, lens, c=c, k=k),))
    if c == 9:
        assert int((got != -1).sum(0).max()) == sp.cap_rows_t(L, c) == 128


def test_sketch_batch_on_card_matches_cpu(cuda, monkeypatch):
    """sketch_batch and profile_step on the card equal the CPU run in each
    branch: B6 (L = 256), B9 (SYLPH_SEED_T), the fallback with B7 seeding
    (L = 256, k = 15) and with the torch seeding (L = 100)."""
    from sylph_tpu_torch.gpu import _cuda
    from sylph_tpu_torch.gpu import pipeline as pl
    from sylph_tpu_torch.gpu.containment import build_host_index
    rng = np.random.default_rng(5)
    bases, lens = _code_batch(6, 512, 256, 31)
    pool = rng.integers(0, (1 << 64) // 20, size=4000, dtype=np.uint64)
    idx = build_host_index([rng.choice(pool, size=300) for _ in range(6)])
    for L, k, t in ((256, 31, False), (256, 31, True), (256, 15, False),
                    (100, 31, False)):
        monkeypatch.setattr(pl, "_USE_TRANSPOSED_SEED", t)
        b, n = bases[:, :L].contiguous(), lens.clamp(max=L)
        _cuda.reset_launches()
        got, gn = pl.sketch_batch(b.to(cuda), n.to(cuda), c=20, k=k)
        want, wn = pl.sketch_batch(b, n, c=20, k=k, device="cpu")
        _equal((got, gn), (want, wn))
        kname = (None if L % 128 else "B9_seed_pack_t" if t
                 else "B6_seed_pack" if k > 16 else "B7_seed")
        if kname:
            assert _cuda.LAUNCHES[kname] == 1
        assert sum(_cuda.LAUNCHES.values()) == (kname is not None)
        # the survivors of the CPU run, planted in the index
        keys = idx.keys.copy()
        live = want[want != -1].numpy()
        keys[:min(live.size, 600)] = live[:600]
        kw = dict(c=20, k=k, n_genomes=6, n_buckets=256)
        h, st = pl.profile_step(b.to(cuda), n.to(cuda), keys,
                                idx.genome_ids, idx.n_kmers, **kw)
        hw, sw = pl.profile_step(b, n, keys, idx.genome_ids, idx.n_kmers,
                                 device="cpu", **kw)
        _equal((h,), (hw,))
        assert int(hw[:, 1:].sum()) > 0
        for f in ("contained", "n_inliers", "median_cov", "valid"):
            _equal((getattr(st, f),), (getattr(sw, f),))
        torch.testing.assert_close(st.final_ani.cpu(), sw.final_ani,
                                   rtol=1e-5, atol=0)


# (n, row, cap, dens): the CPU test's geometries (tests/
# test_torch_repack_rows.py), the last of each list overflowing its rows
_ROWS = [(20_000, 1024, 256, 0.15), (30_000, 384, 128, 0.2),
         (50_000, 640, 256, 0.2), (300 * 128 - 50, 128, 128, 0.3),
         (17 * 32768 + 100, 32768, 1024, 0.02), (40_000, 512, 128, 0.35)]


@pytest.mark.parametrize("n,row,cap,dens", _ROWS)
def test_repack_rows_match_plain(cuda, n, row, cap, dens):
    """B11 (int64 keys, with a few keys whose high word is 0xFFFFFFFF) and
    B12 (int32 codes) against their plain versions, bit for bit, with the
    launch counted."""
    from sylph_tpu_torch.gpu import _cuda
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**62, size=n, dtype=np.int64)
    keys[rng.random(n) > dens] = -1
    keys[rng.integers(0, n, size=8)] = -(1 << 32) + 5    # high word SENT
    codes = rng.integers(0, 2**31, size=n).astype(np.int32)
    codes[rng.random(n) > dens] = -1
    keys, codes = torch.from_numpy(keys), torch.from_numpy(codes)
    before = dict(_cuda.LAUNCHES)
    got = sd.repack_rows(keys.to(cuda), row=row, cap=cap)
    _equal((got,), (sd.repack_rows_plain(keys, row=row, cap=cap),))
    got = sd.repack1_rows(codes.to(cuda), row=row, cap=cap)
    _equal((got,), (sd.repack1_rows_plain(codes, row=row, cap=cap),))
    for name in ("B11_repack_rows", "B12_repack1_rows"):
        assert _cuda.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("kind,n", [("identity", 0)] + [
    (k, n) for k in ("alu", "lane_roll", "half_roll", "warp_roll",
                     "sublane_roll", "rank", "barrier", "funnel")
    for n in (16, 64)])
def test_kbench_kernels_match_plain(cuda, kind, n):
    """Every kbench microkernel against its plain version on a [512, 256]
    batch (two sublane tiles)."""
    from sylph_tpu_torch import kbench
    rng = np.random.default_rng(n + len(kind))
    x = torch.from_numpy(rng.integers(0, 2**32, size=(512, 256),
                                      dtype=np.uint32).view(np.int32))
    got = kbench.launch(kind, x.to(cuda), n)
    _equal((got,), (kbench.PLAIN[kind](x, n),))


# ---- the redesigned B7 and B1 ----------------------------------------------

@pytest.mark.parametrize("L", [16, 48, 128, 256, 512, 4096])
@pytest.mark.parametrize("k", [1, 15, 16, 21, 31])
def test_seed_warp_pieces_match_plain(cuda, L, k):
    """B7's warp-per-piece kernel at row lengths below one 256-base piece,
    at one and at several pieces, k from 1 to 31, c = 1 and 200: rows of
    length L, 0 and k - 1 among random ones, N = 37 (not a multiple of the
    8 warps a block), every hash and keep bit for bit."""
    N = 37
    packed, lens = _packed_batch(L + k, N, L)
    lens[2] = k - 1
    for c in (1, 200):
        got = sd.seed_packed(packed.to(cuda), lens.to(cuda), c=c, k=k)
        want = sd.seed_packed_plain(packed, lens, c=c, k=k)
        _equal(got, want)
        assert int(want[1][1:3].sum()) == 0
        assert c > 1 or int(want[1][0].sum()) == L - k + 1 > 0 or L < k


@pytest.mark.parametrize("N,L,blocks", [
    (8000, 1280, None),        # 40,000 pieces, 5 a row, the card's grid
    (70_000, 48, None),        # 70,000 one-piece rows, the card's grid
    (301, 1280, 3),            # 24 warps over 5 pieces a row: the warp's
    (97, 1792, 5),             # piece steps past the row's end (40 over 7)
    (53, 768, 1),              # 8 warps over 3 pieces a row
    (41, 4096, 7)])            # 56 warps over 16 pieces a row
def test_seed_grid_stride_matches_plain(cuda, monkeypatch, N, L, blocks):
    """B7's grid-stride loop: more pieces than warps in the grid, with a
    stride that the pieces a row do not divide, so a warp's next piece
    lies in another row at another piece (the carry of ``p += stride_p``).
    At the card's own grid (4,224 warps on a 132-SM H100) and at grids of
    a few blocks; every hash and keep bit for bit."""
    if blocks is not None:
        monkeypatch.setattr(sd, "_seed_grid", lambda dev: blocks)
    packed, lens = _packed_batch(L + 21, N, L)
    got = sd.seed_packed(packed.to(cuda), lens.to(cuda), c=5, k=21)
    _equal(got, sd.seed_packed_plain(packed, lens, c=5, k=21))


def test_seed_empty_batch(cuda):
    """N = 0 rows: empty outputs and no kernel work; a batch of no words a
    row raises, as the plain version does."""
    packed = torch.zeros((0, 16), dtype=torch.int32)
    lens = torch.zeros(0, dtype=torch.int32)
    got = sd.seed_packed(packed.to(cuda), lens.to(cuda), c=200, k=31)
    _equal(got, sd.seed_packed_plain(packed, lens, c=200, k=31))
    with pytest.raises(ValueError):
        sd.seed_packed(torch.zeros((4, 0), dtype=torch.int32, device=cuda),
                       torch.zeros(4, dtype=torch.int32, device=cuda),
                       c=200, k=31)


def _skewed_slice(seed, B, width, base, heavy, n_live=6000):
    """A sorted slice like _slice's, plus ``heavy`` keys in one sub-range
    of bucket B // 2 whose weights run in long zero stretches (folded
    duplicates) between live ones; KEY_PAD tail."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(base - 3 * width, base + (B + 2) * width, size=n_live)
    hh = np.full(heavy, base + (B // 2) * width + width - 2)
    hi = np.concatenate([hi, hh])
    lo = rng.integers(0, 2**32, size=hi.size)
    keys, idx = np.unique((hi.astype(np.int64) << 32) | lo,
                          return_index=True)
    w = rng.integers(0, 6, size=hi.size).astype(np.int32)[idx]
    hv = (keys >> 32) == base + (B // 2) * width + width - 2
    run = (np.cumsum(hv) // 700) % 2 == 0          # stretches of 700
    w[hv & run] = 0
    w[hv & ~run] = np.maximum(w[hv & ~run], 1)
    P = keys.size + 777
    k = np.full(P, -1, np.int64)
    ww = np.zeros(P, np.int32)
    k[:keys.size], ww[:keys.size] = keys, w
    return torch.from_numpy(k), torch.from_numpy(ww)


@pytest.mark.parametrize("CS", [1, 3, 16, 36, 256])
@pytest.mark.parametrize("nt,subwidth", [(1, 0), (4, 15)])
def test_fill_block_runs_match_plain(cuda, CS, nt, subwidth):
    """B1's block-per-cell-run kernel under skew: a cell of 12,000 entries
    in zero-weight stretches, B = 301 buckets (NC not a multiple of the
    cells a block takes), nt = 4 with subwidth 15 of width 64 (the last
    sub-range wider), CS from 1 (overflow everywhere) to 256."""
    B, width, base = 301, 64, 1 << 20
    k, w = _skewed_slice(CS + nt, B, width, base, 12_000)
    kw = dict(width=width, B=B, CS=CS, nt=nt, subwidth=subwidth)
    cpb = bf.fill_plan(k.shape[0], B * nt, CS)
    assert (B * nt) % cpb or cpb == 1
    got = bf.bucket_fill(k.to(cuda), w.to(cuda), base, **kw)
    want = bj._sample_to_buckets(k, w, base=base, **kw)
    _equal(got, want)
    heavy = (B // 2) * nt + (nt - 1)
    assert int((want[1][heavy] > 0).sum()) == CS


@pytest.mark.parametrize("CS", [5000, 19_363])
def test_fill_wide_cells_match_plain(cuda, CS):
    """A block of one cell whose slots need more than the 48 KB of shared
    memory a launch gets without opting in (60 KB at CS 5,000, 227 KB at
    the widest CS the plan takes), with a 12,000-entry cell."""
    B, width, base = 7, 64, 1 << 20
    k, w = _skewed_slice(CS, B, width, base, 12_000, n_live=300)
    kw = dict(width=width, B=B, CS=CS, nt=1, subwidth=0)
    assert bf.fill_plan(k.shape[0], B, CS) == 1
    got = bf.bucket_fill(k.to(cuda), w.to(cuda), base, **kw)
    want = bj._sample_to_buckets(k, w, base=base, **kw)
    _equal(got, want)
    assert int((want[1][B // 2] > 0).sum()) >= 5000


def test_fill_out_of_order_slice_stays_in_bounds(cuda):
    """A slice out of the kernel's uint64 order (keys of 2^63 and up put
    ahead of the rest, as an int64 sort would put them): the blocks find
    wrong ranges but write only their own cells, so the launch completes,
    and the next launch on an ordered slice is exact."""
    rng = np.random.default_rng(5)
    B, n = 512, 20_000
    width = (1 << 32) // B
    hi = rng.integers(0, B * width, size=n)
    keys = np.sort(np.unique((hi.astype(np.int64) << 32)
                             | rng.integers(0, 1 << 32, size=n)))
    assert keys[0] < 0 < keys[-1]
    w = torch.from_numpy(rng.integers(1, 6, size=keys.size).astype(np.int32))
    kw = dict(width=width, B=B, CS=16, nt=4, subwidth=-(-width // 4))
    got = bf.bucket_fill(torch.from_numpy(keys).to(cuda), w.to(cuda), 0,
                         **kw)
    torch.cuda.synchronize()
    assert got[0].shape == (B * 4, 16)
    k, w = _skewed_slice(9, 301, 64, 1 << 20, 3000)
    kw = dict(width=64, B=301, CS=16, nt=4, subwidth=15)
    _equal(bf.bucket_fill(k.to(cuda), w.to(cuda), 1 << 20, **kw),
           bj._sample_to_buckets(k, w, base=1 << 20, **kw))


@pytest.mark.parametrize("P", [0, 4096])
def test_fill_empty_and_all_pad_slices(cuda, P):
    """P = 0 and a slice of pads only: every cell all pads."""
    k = torch.full((P,), -1, dtype=torch.int64)
    w = torch.zeros(P, dtype=torch.int32)
    for nt in (1, 4):
        kw = dict(width=64, B=130, CS=3, nt=nt, subwidth=16 if nt > 1 else 0)
        got = bf.bucket_fill(k.to(cuda), w.to(cuda), 1 << 20, **kw)
        want = bj._sample_to_buckets(k, w, base=1 << 20, **kw)
        _equal(got, want)
        assert int((got[0] != -1).sum()) == 0


def test_seed_and_fill_occupancy(cuda):
    """The occupancy readouts: at least one resident block a SM for B7 (its
    grid all of them) and for B1's plans at CS 16, 36 and 256, whose
    blocks take the shared memory their staged slots need; a cell past 227
    KB is refused."""
    occ = sd.seed_occupancy()
    assert occ["ctas_per_sm"] >= 1 and occ["threads"] == 256
    assert sd._seed_grid(torch.device(cuda)) == occ["ctas_per_sm"] * \
        torch.cuda.get_device_properties(cuda).multi_processor_count
    for P, NC, CS in ((300_000, 131_072, 16), (1_500_000, 131_072, 36),
                      (5_300_000, 65_536, 256), (10, 4, 19_363)):
        cpb = bf.fill_plan(P, NC, CS)
        occ = bf.fill_occupancy(cpb, CS)
        assert occ["ctas_per_sm"] >= 1
        assert cpb * CS * 12 <= occ["smem_bytes"] <= 232448
    with pytest.raises(RuntimeError):
        bf.fill_occupancy(1, 19_400)


def _main_chunk(seed, B, CS, nt=4, tile=256, ov=128, G=9):
    """_main_geometry at a whole chunk's B rows, built without a row loop,
    with _adversarial_join's traps: pad slots holding gids below G, in a
    fifth of the rows a lane of key -1 and weight > 0, zero weights
    between live lanes, a lane group emptied in some rows."""
    rng = np.random.default_rng(seed)
    width, base = 1 << 15, 1 << 20        # high words below 2^31
    subw = width // nt
    CI = nt * tile + ov
    rows = np.arange(B)
    hi = (base + rows[:, None, None] * width
          + np.arange(nt)[None, :, None] * subw
          + rng.integers(0, subw, size=(B, nt, tile)))
    kk = np.sort((hi << 32) | rng.integers(0, 2**32, size=(B, nt, tile)),
                 axis=2)
    n = rng.integers(tile * 9 // 10, tile + 1, size=(B, nt))
    kk[np.arange(tile)[None, None, :] >= n[:, :, None]] = -1
    keys = np.empty((B, CI), np.int64)
    keys[:, :nt * tile] = kk.reshape(B, nt * tile)
    del hi, kk
    hio = base + rows[:, None] * width + rng.integers(0, width, size=(B, ov))
    ko = (hio << 32) | rng.integers(0, 2**32, size=(B, ov))
    ko[np.arange(ov)[None, :] >= rng.integers(0, 30, size=B)[:, None]] = -1
    keys[:, nt * tile:] = ko
    live = keys != -1
    gid = rng.integers(0, G, size=(B, CI)).astype(np.int32)
    gid[~live & (rng.random((B, CI)) < 0.9)] = G
    pool = keys[live]
    n_smp = B * nt * CS // 4
    own = pool[rng.integers(0, pool.size, size=n_smp // 2)]
    hs = base + rng.integers(0, B * width, size=n_smp - own.size)
    sk = np.unique(np.concatenate([own, (hs << 32) | rng.integers(
        0, 2**32, size=hs.size)]))
    sw = rng.integers(1, 90, size=sk.size).astype(np.int32)
    sw[rng.random(sk.size) < 0.3] = 0
    dk, dw = bj._sample_to_buckets(torch.from_numpy(sk), torch.from_numpy(sw),
                                   width=width, B=B, CS=CS, base=base, nt=nt,
                                   subwidth=subw)
    dk, dw = dk.view(B, nt * CS).numpy().copy(), dw.view(B, nt * CS).numpy()
    dw = dw.copy()
    neg = np.flatnonzero(rng.random(B) < 0.2)
    lane = rng.integers(0, nt * CS, size=neg.size)
    dk[neg, lane] = -1
    dw[neg, lane] = rng.integers(1, 90, size=neg.size)
    empty = np.flatnonzero(rng.random(B) < 0.15)
    grp = rng.integers(0, nt, size=empty.size)
    for g in range(nt):
        dw[empty[grp == g], g * CS:(g + 1) * CS] = 0
    return (torch.from_numpy(keys), torch.from_numpy(gid),
            torch.from_numpy(dk), torch.from_numpy(dw))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("CS", [16, 40])
def test_join_stress_two_streams_main_chunk(cuda, seed, CS):
    """join.cu at the GTDB-scale chunk (B = 32,768, CI = 1,152, nt = 4,
    tile 256), lane lists of the sample's (CS 16) and the deep sample's (CS
    40) size, with pad-key traps: B5, B4 and B2 launched 4 times each from
    two streams at once, interleaved, every launch equal to the plain
    version (computed on the card). A race in the staging ring would show
    as a launch that differs."""
    B, nt, tile, G, capr = 32768, 4, 256, 9, 24
    ikey, gid, dk, dw = (t.to(cuda) for t in _main_chunk(seed, B, CS))
    assert ikey.shape == (B, 1152)
    kw = dict(nt=nt, tile=tile)
    want = ((bj.join_counts_plain(ikey, dk, dw, **kw),),
            (bj.join_codes_plain(ikey, gid, dk, dw, G=G, **kw),),
            bj.join_codes_compact_plain(ikey, gid, dk, dw, G=G, CAPR=capr,
                                        **kw))
    assert int((want[2][0] != -1).sum()) > 0
    runs = (lambda: (bj.join_counts(ikey, dk, dw, **kw),),
            lambda: (bj.join_codes(ikey, gid, dk, dw, G=G, **kw),),
            lambda: bj.join_codes_compact(ikey, gid, dk, dw, G=G, CAPR=capr,
                                          **kw))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        for m, run in enumerate(runs):
            for st in streams:
                with torch.cuda.stream(st):
                    got.append((m, run()))
    torch.cuda.synchronize()
    bad = [i for i, (m, out) in enumerate(got)
           if not all(torch.equal(a, b) for a, b in zip(out, want[m]))]
    assert not bad, f"launches {bad} of {len(got)} differ from the plain"


# ---- csrc/repack.cu (B3, B8, B11, B12) at its launch geometries -----------

_REPACK = {4: ("repack_launch", torch.int32, "B3_repack"),
           8: ("repack64_launch", torch.int64, "B8_repack2")}
# B3's first pass over a GTDB-scale chunk's code stream and B8's over a
# [65,536, 256] batch of reads, as chip_smoke.py prints them: (n, row, cap,
# live share)
_B3_MAIN = (14_155_776, 8192, 2816, 0.0122)
_B8_MAIN = (2_162_688, 32768, 1536, 0.0483)


def _pad_stream(seed, n, width, dens, odd=0):
    """n slots, live at density ``dens`` (int32 codes below 2^31, int64
    keys below 2^62), pad -1 else; ``odd`` int64 keys whose high word is
    0xFFFFFFFF and whose low word is not (live in the port, ROADMAP C)."""
    rng = np.random.default_rng(seed)
    if width == 4:
        v = rng.integers(0, 2**31, size=n).astype(np.int32)
    else:
        v = rng.integers(0, 2**62, size=n, dtype=np.int64)
    v[rng.random(n) > dens] = -1
    if odd and n:
        v[rng.integers(0, n, size=odd)] = -(1 << 32) + 5
    return torch.from_numpy(v)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("n,nwin,row,cap,dens", [
    (16384, 1, 16384, 768, 0.034),            # one window
    (7 * 16384 - 300, 7, 16384, 768, 0.034),  # the stream ends mid-piece
    (2_200_000, 136, 16384, 768, 0.034),      # 136 windows on 132 SMs
    (9 * 32768 - 5, 9, 32768, 256, 0.001),    # one past a multiple of 8
    (33 * 4096, 33, 4096, 256, 0.4),          # every window overflows cap
    (8 * 32768, 8, 32768, 256, 0.0),          # all pad
    (0, 8, 16384, 768, 0.5),                  # n = 0
    (100, 8, 1024, 256, 0.5),                 # n < row
    (3 * 32768, 3, 32768, 32768, 0.5),        # cap == row
    (5 * 2048 + 17, 6, 2048, 2048, 0.7),
    (5 * 24576, 5, 24576, 512, 0.01),         # pieces of 6,144 / 3,072
    (5 * 24704 + 7, 6, 24704, 512, 0.02),     # a window's last piece short
    (2 * 65664, 2, 65664, 512, 0.01),         # a round of empty pieces
    (3 * 131072 + 999, 4, 131072, 1024, 0.004),   # rounds of 8 pieces
    (2 * 131072, 2, 131072, 256, 0.3),        # a full window stops early
    (50_000, 79, 640, 256, 0.2),              # B11/B12's 128-lane rows
    (300 * 128 - 50, 512, 128, 128, 0.3),
    (30_000, 79, 384, 128, 0.2)])
def test_repack_windows_match_plain(cuda, width, n, nwin, row, cap, dens):
    """csrc/repack.cu through launch_repack, at any window count, against
    repack_windows_plain bit for bit: window counts of 1, 7, 9 and 136,
    overflowing windows, all-pad and empty streams, cap == row, pieces
    that do not divide 32 KB, a window whose last piece is short (pieces
    tile a window, so no window boundary falls inside one), windows taken
    in rounds (the early stop, a round with empty pieces), the row
    repacks' 128-lane geometries; int64 with the pad-rule keys."""
    entry, dtype, kname = _REPACK[width]
    v = _pad_stream(n + row, n, width, dens, odd=8 if width == 8 else 0)
    got = bf.launch_repack(v.to(cuda), nwin, row, cap, dtype, entry, kname)
    _equal((got,), (bf.repack_windows_plain(v, nwin, row, cap),))


@pytest.mark.parametrize("width", [4, 8])
def test_repack_unaligned_stream_matches_plain(cuda, width):
    """A stream that starts off 16 bytes (a view at slot 1) is read slot by
    slot instead of by bulk copy, with the same output."""
    entry, dtype, kname = _REPACK[width]
    v = _pad_stream(5, 4 * 16384 + 1, width, 0.05)
    got = bf.launch_repack(v.to(cuda)[1:], 4, 16384, 768, dtype, entry,
                           kname)
    _equal((got,), (bf.repack_windows_plain(v[1:], 4, 16384, 768),))


@pytest.mark.parametrize("width,shape", [(4, _B3_MAIN), (8, _B8_MAIN)])
def test_repack_main_shapes_match_plain(cuda, width, shape):
    """B3 and B8 through their wrappers at the main path's first passes,
    against the plain version computed on the card, with the launch
    counted. At B8's live share, as on the main path's reads, some windows
    overflow cap."""
    from sylph_tpu_torch.gpu import _cuda
    n, row, cap, dens = shape
    v = _pad_stream(n, n, width, dens).to(cuda)
    fn = bf.repack1_flat if width == 4 else bf.repack2_flat
    kname = _REPACK[width][2]
    n0 = _cuda.LAUNCHES[kname]
    got = fn(v, row=row, cap=cap)
    assert _cuda.LAUNCHES[kname] == n0 + 1
    want = bf.repack1_flat_plain(v, row=row, cap=cap)
    assert int((want != -1).sum()) > 0
    _equal((got,), (want,))


def test_repack_stress_two_streams_main_shapes(cuda):
    """B3 and B8 at the main shapes launched 4 times each from two streams
    at once, interleaved, every launch equal to the plain version (on the
    card): a cluster barrier or a staging ring that let one launch see
    another's counts or slots would show as a launch that differs."""
    runs = []
    for width, (n, row, cap, dens) in ((4, _B3_MAIN), (8, _B8_MAIN)):
        v = _pad_stream(n + 1, n, width, dens).to(cuda)
        fn = bf.repack1_flat if width == 4 else bf.repack2_flat
        runs.append((lambda f=fn, v=v, row=row, cap=cap:
                     f(v, row=row, cap=cap),
                     bf.repack1_flat_plain(v, row=row, cap=cap)))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        for m, (run, _want) in enumerate(runs):
            for st in streams:
                with torch.cuda.stream(st):
                    got.append((m, run()))
    torch.cuda.synchronize()
    bad = [i for i, (m, out) in enumerate(got)
           if not torch.equal(out, runs[m][1])]
    assert not bad, f"launches {bad} of {len(got)} differ from the plain"


def test_repack_occupancy(cuda):
    """The occupancy readout at the main plans (B3: one CTA a window; B8: a
    cluster of 8 CTAs; 32 KB pieces), at cap == row and at a 128-lane row;
    every plan leaves 5 CTAs a SM resident (the kernel's launch bound),
    and clusters."""
    for row, cap, dtype, plan in ((8192, 2816, torch.int32, (1, 8192)),
                                  (32768, 1536, torch.int64, (8, 4096)),
                                  (32768, 32768, torch.int32, (4, 8192)),
                                  (384, 128, torch.int64, (1, 384))):
        occ = bf.repack_occupancy(row, cap, dtype)
        assert (occ["cluster"], occ["piece"]) == plan
        width = 4 if dtype == torch.int32 else 8
        assert occ["smem_bytes"] >= plan[1] * width
        assert occ["ctas_per_sm"] >= 5 and occ["clusters_resident"] >= 1
        assert occ["threads"] == 256


# ---- csrc/seed_pack.cu: the row kernel (B6, B10), the column kernel (B9) ---

def _read_rows(seed, N, L, k):
    """Random reads; rows 0-5 of lengths L, 0, k - 1, k, 150 and past L
    (as many as N holds), rows 6-7 ATAT... repeats (every 31-mer window
    below u64::MAX / 9) of length L, the rest of random lengths up to
    L."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    bases[6:8] = np.resize(np.array([0, 3], np.uint8), L)
    lens = rng.integers(0, L + 1, size=N).astype(np.int32)
    head = (L, 0, k - 1, k, min(150, L), L + 40, L, L)
    lens[:min(N, 8)] = head[:min(N, 8)]
    return torch.from_numpy(bases), torch.from_numpy(lens)


def _rows_all(cuda, bases, lens, c, k):
    """B6 at 128 lanes and at compact_cap lanes, and B10, against their
    plain versions."""
    from sylph_tpu_torch.gpu import seed_pack as sp
    bd, ld = bases.to(cuda), lens.to(cuda)
    L = bases.shape[1]
    if k >= 17:
        cap = sp.compact_cap(L, c)
        for lanes in (sp.CAP_LANES, cap):
            _equal((sp.seed_pack(bd, ld, c=c, k=k, lanes=lanes),),
                   (sp.seed_pack_plain(bases, lens, c=c, k=k, lanes=lanes),))
    _equal((sp.seed_compact(bd, ld, c=c, k=k),),
           (sp.seed_compact_plain(bases, lens, c=c, k=k),))


@pytest.mark.parametrize("N", [1, 7, 256])
@pytest.mark.parametrize("L,c", [(128, 3), (384, 20), (512, 2), (4096, 50)])
def test_seed_pack_rows_geometry_matches_plain(cuda, N, L, c):
    """The row kernel over 1 to 16 pieces a read (L = 128 is half a
    piece), N of one read, of fewer reads than a block's 8 warps and of
    one Pallas block, lengths of 0, k - 1, k, 150, L and past L, more than
    128 survivors a read (c = 2, the ATAT rows)."""
    bases, lens = _read_rows(N * 7 + L, N, L, 31)
    _rows_all(cuda, bases, lens, c, 31)


@pytest.mark.parametrize("N,L,blocks", [
    (8192, 256, None),       # more reads than the card's resident warps
    (2048, 384, 1),          # 8 warps over 2,048 two-piece reads
    (256, 1024, 3)])         # 24 warps, the stride not a multiple of 8
def test_seed_pack_rows_grid_stride_matches_plain(cuda, monkeypatch, N, L,
                                                  blocks):
    """The row kernel's grid-stride loop and its prefetch of the next
    read's first piece: at the card's own grid (5,280 warps on a 132-SM
    H100 at 5 blocks a SM) and at grids of a few blocks."""
    from sylph_tpu_torch.gpu import seed_pack as sp
    if blocks is not None:
        monkeypatch.setattr(sp, "_resident_rows", lambda dev: blocks)
    bases, lens = _read_rows(N + L, N, L, 31)
    _rows_all(cuda, bases, lens, 20, 31)


def test_seed_pack_cap_at_piece_edge_and_inside_step(cuda):
    """The early stop: B6 with its lane count set to read 0's survivors in
    the windows of its first piece (the cap reached at the piece edge or
    before it, the next piece's first step skipped), in windows 0-99
    (inside step 1), in windows 0-383 (at a step edge in the second
    piece) and one past that, at c = 3 over 512-base reads."""
    from sylph_tpu_torch.gpu import seed_pack as sp
    N, L, c, k = 256, 512, 3, 31
    bases, lens = _read_rows(11, N, L, k)
    lens[0] = L
    h, keep = sd.seed_hashes(bases[:1], lens[:1], c=c, k=k)
    csum = torch.cumsum(keep[0].to(torch.int64), 0)
    lanes = {int(csum[255]), int(csum[99]), int(csum[383]),
             int(csum[383]) + 1}
    bd, ld = bases.to(cuda), lens.to(cuda)
    for n in sorted(x for x in lanes if 1 <= x <= sp.CAP_LANES):
        _equal((sp.seed_pack(bd, ld, c=c, k=k, lanes=n),),
               (sp.seed_pack_plain(bases, lens, c=c, k=k, lanes=n),))


def test_seed_pack_long_rows_match_plain(cuda):
    """L = 2^17 bases a read (512 pieces), N = 8: the row kernel keeps a
    piece's words in registers, so L has no limit of its own."""
    bases, lens = _read_rows(17, 8, 1 << 17, 31)
    _rows_all(cuda, bases, lens, 200, 31)


@pytest.mark.parametrize("N", [8, 100, 1024])
@pytest.mark.parametrize("L,c", [(8, 2), (40, 2), (256, 2), (512, 2),
                                 (256, 200), (1024, 30)])
def test_seed_pack_cols_geometry_matches_plain(cuda, N, L, c):
    """The column kernel: N below one 512-column Pallas block (8; 100,
    off 16 bytes, read byte by byte) and a multiple of it (1,024: 8
    tiles); L of less than a word (8), of a word and a half (40), one
    piece and two (512) and four (1,024); at c = 2 cap_rows is L, so
    every survivor past the 32 staged rows goes straight to its slot;
    lengths of 0, k - 1, k, 150, L and past L, the ATAT reads."""
    from sylph_tpu_torch.gpu import seed_pack as sp
    k = 21 if L < 31 else 31
    bases, lens = _read_rows(N + 3 * L, N, L, k)
    bt = bases.t().contiguous()
    got = sp.seed_pack_t(bt.to(cuda), lens.to(cuda), c=c, k=k)
    _equal((got,), (sp.seed_pack_t_plain(bt, lens, c=c, k=k),))
    if c == 2 and L >= 256:
        assert int((got != -1).sum(0).max()) > sp.COL_STAGE


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_pack_stress_two_streams_main_shapes(cuda, seed):
    """B6 (13 lanes) and B9 at (q)'s [65,536, 256] batch, c = 200, k =
    31, launched 4 times each from two streams at once, interleaved,
    every launch equal to the plain version (computed on the card)."""
    from sylph_tpu_torch.gpu import seed_pack as sp
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    bases = torch.randint(0, 4, (65536, 256), generator=gen,
                          dtype=torch.uint8, device=cuda)
    lens = torch.randint(0, 300, (65536,), generator=gen,
                         dtype=torch.int32, device=cuda)
    bt = bases.t().contiguous()
    runs = [(lambda: sp.seed_pack(bases, lens, c=200, k=31, lanes=13),
             sp.seed_pack_plain(bases, lens, c=200, k=31, lanes=13)),
            (lambda: sp.seed_pack_t(bt, lens, c=200, k=31),
             sp.seed_pack_t_plain(bt, lens, c=200, k=31))]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        for m, (run, _want) in enumerate(runs):
            for st in streams:
                with torch.cuda.stream(st):
                    got.append((m, run()))
    torch.cuda.synchronize()
    bad = [i for i, (m, out) in enumerate(got)
           if not torch.equal(out, runs[m][1])]
    assert not bad, f"launches {bad} of {len(got)} differ from the plain"


def test_seed_pack_occupancy(cuda):
    """The occupancy readouts of the row and column kernels: 256 threads,
    at least 5 and 4 blocks a SM (their launch bounds), the column
    kernel's static tables (words, the 32 staged rows, counts); the row
    kernel's grid is the resident blocks."""
    from sylph_tpu_torch.gpu import seed_pack as sp
    rows, cols = sp.seed_pack_occupancy("rows"), sp.seed_pack_occupancy("cols")
    for occ, blocks in ((rows, 5), (cols, 4)):
        assert occ["threads"] == 256 and occ["ctas_per_sm"] >= blocks
        assert occ["regs"] <= 65536 // (256 * blocks)
    assert cols["smem_bytes"] >= (sp.COL_TILE * 19 * 4
                                  + sp.COL_STAGE * sp.COL_TILE * 8)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sp._resident_rows(torch.device(cuda)) == rows["ctas_per_sm"] * sms
    with pytest.raises(ValueError):
        sp.seed_pack_occupancy("tiles")


# ---- c = 1: keys of 2^63 and up, in uint64 order (ROADMAP C1) ---------------

_U64_MAX = np.iinfo(np.uint64).max


def _c1_keys(rng, n):
    """n distinct hashes kept at c = 1 (below u64::MAX), sorted in uint64
    order, about half of them 2^63 or more."""
    k = np.unique(rng.integers(0, _U64_MAX, size=n, dtype=np.uint64))
    assert (k >= np.uint64(1 << 63)).any() and (k < np.uint64(1 << 63)).any()
    return k


@pytest.mark.parametrize("nt", [1, 4])
@pytest.mark.parametrize("where", ["straddle", "top"])
def test_fill_uint64_ordered_slice_matches_plain(cuda, nt, where):
    """B1 on a slice sorted in uint64 order that holds keys of 2^63 and
    up: across the 2^63 edge (bucket base below it), and at the top of the
    range, where real high words reach 0xFFFFFFFF, the pad's."""
    rng = np.random.default_rng(60 + nt)
    B, width = 512, 1 << 12
    base = (1 << 31) - (B // 2) * width if where == "straddle" \
        else (1 << 32) - B * width
    hi = rng.integers(base - 3 * width, min(base + (B + 2) * width, 1 << 32),
                      size=20_000)
    if where == "top":
        hi[:300] = 0xFFFFFFFF
    keys = np.unique((hi.astype(np.uint64) << np.uint64(32))
                     | rng.integers(0, 1 << 32, size=hi.size,
                                    dtype=np.uint64))
    keys = keys[keys < _U64_MAX]
    assert (keys >= np.uint64(1 << 63)).any()
    if where == "top":
        assert (keys >> np.uint64(32) == np.uint64(0xFFFFFFFF)).any()
    P = keys.size + 500
    k = np.full(P, -1, np.int64)
    k[:keys.size] = keys.view(np.int64)
    w = np.zeros(P, np.int32)
    w[:keys.size] = rng.integers(0, 6, size=keys.size)
    k, w = torch.from_numpy(k), torch.from_numpy(w)
    kw = dict(width=width, B=B, CS=16, nt=nt,
              subwidth=-(-width // nt) if nt > 1 else 0)
    got = bf.bucket_fill(k.to(cuda), w.to(cuda), base, **kw)
    want = bj._sample_to_buckets(k, w, base=base, **kw)
    _equal(got, want)
    assert int((want[1] > 0).sum()) > B


@pytest.mark.parametrize("nt", [1, 4])
def test_engine_c1_sweeps_on_card_match_cpu(cuda, nt):
    """The grange engine over c = 1 hashes: the per-chunk sweep (hists),
    the occurrence-stream sweep (hist_device_stream: fold_stream, device
    offsets), the streamed device view (device sort, one-fetch mask) and
    the batched sweep (batched_slices), each on the card equal to the
    CPU's."""
    from sylph_tpu_torch.engine.device_sketch import DeviceSampleStream
    rng = np.random.default_rng(70 + nt)
    G, m = 40, 150_000
    kmers = _c1_keys(rng, m)
    gids = rng.integers(0, G, size=kmers.size).astype(np.int32)
    sk = np.unique(np.concatenate([rng.choice(kmers, size=4000),
                                   _c1_keys(rng, 4000)]))
    sc = rng.integers(1, 40, size=sk.size).astype(np.uint32)
    idx = gr.build_grange_index(kmers, gids, G, chunk_slots=1 << 15,
                                target_mean=512 if nt > 1 else 64, nt=nt,
                                device=cuda)
    assert idx.edges_u64[0, 0] < np.uint64(1 << 63) <= idx.edges_u64[-1, 1]
    on_cpu = gr.GRangeEngine(idx, device="cpu")
    on_card = gr.GRangeEngine(idx, device=cuda)
    want = on_cpu.hists(sk, sc)
    np.testing.assert_array_equal(on_card.hists(sk, sc), want)
    assert want.sum() > 0

    stream = np.repeat(sk.view(np.int64), np.minimum(sc, 5))
    stream = torch.from_numpy(rng.permutation(stream))
    h_cpu, p_cpu, _ = on_cpu.hist_device_stream(stream)
    h_card, p_card, _ = on_card.hist_device_stream(stream.to(cuda))
    assert torch.equal(h_card.cpu(), h_cpu) and int(p_cpu[0]) == 0
    assert torch.equal(p_card.cpu(), p_cpu)

    def view(device):
        st = DeviceSampleStream(torch.device(device))
        perm = rng.permutation(sk.size)
        st.push(sk[perm])
        return st.finalize(sk[perm], sc[perm])
    nk = torch.from_numpy(np.bincount(gids, minlength=G).astype(np.int32))

    def mask_fn(h):
        return (h.view(G, -1)[:, 1:].sum(1) * 50 > nk.to(h.device))
    a = on_cpu.candidate_mask_stream(view("cpu"), mask_fn)
    b = on_card.candidate_mask_stream(view(cuda), mask_fn)
    assert a is not None and b is not None
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] and a[0].any()

    tables = [(sk, sc), (sk[::3], sc[::3])]
    np.testing.assert_array_equal(on_card.hists_batched(tables),
                                  on_cpu.hists_batched(tables))
    # the card may capture and replay its stream sweeps where the CPU runs
    # them eagerly
    card, cpu = dict(on_card.counters), dict(on_cpu.counters)
    ways = ("stream_graph_replays", "stream_graph_captures",
            "stream_eager_sweeps")
    assert sum(card.pop(k) for k in ways) == cpu["stream_eager_sweeps"] == 2
    assert cpu.pop("stream_graph_replays") == 0
    assert cpu.pop("stream_graph_captures") == 0
    cpu.pop("stream_eager_sweeps")
    assert card == cpu


def _c1_world(tmp, rng):
    """db.syldb of 70 genomes of c = 1 hashes (64 or more, so the grange
    regime's device prefilter sweeps) and s.sylsp planting 6 of them, for
    the CLI."""
    from sylph_tpu_torch.core.types import GenomeSketch, SequencesSketch
    from sylph_tpu_torch.io import sylformat
    pool = _c1_keys(rng, 400_000)
    gs = [GenomeSketch(rng.choice(pool, size=5000, replace=False),
                       np.empty(0, np.uint64), f"g{i}.fa", f"c{i}", 1, 31,
                       5000, 30) for i in range(70)]
    picks = rng.choice(70, size=6, replace=False)
    km = np.unique(np.concatenate([gs[g].genome_kmers for g in picks]
                                  + [_c1_keys(rng, 20_000)]))
    sk = SequencesSketch(km, (1 + rng.poisson(3, size=km.size)).astype(
        np.uint32), 1, 31, "s.fq", None, False, 150.0)
    db, smp = str(tmp / "db.syldb"), str(tmp / "s.sylsp")
    sylformat.write_syldb(db, gs)
    sylformat.write_sylsp(smp, sk)
    return db, smp, {gs[g].file_name for g in picks}


def test_c1_regimes_on_card_give_one_tsv(cuda, tmp_path, monkeypatch):
    """profile of a c = 1 database on the card in the bucket and grange
    regimes (BUCKET_MIN, CHUNK and GRANGE_MIN patched) gives the merge
    regime's TSV, which lists the planted genomes, and the CPU's."""
    from sylph_tpu_torch import cli
    from sylph_tpu_torch.engine.device_exec import DeviceContainment
    db, smp, planted = _c1_world(tmp_path, np.random.default_rng(80))
    tsv = {}
    for regime, dev in (("merge", "cuda"), ("bucket", "cuda"),
                        ("grange", "cuda"), ("grange", "cpu")):
        monkeypatch.setattr(DeviceContainment, "BUCKET_MIN",
                            1000 if regime == "bucket" else 1 << 24)
        monkeypatch.setattr(DeviceContainment, "CHUNK",
                            1 << 16 if regime == "bucket" else 1 << 22)
        monkeypatch.setattr(DeviceContainment, "GRANGE_MIN",
                            0 if regime == "grange" else 1 << 26)
        out = tmp_path / f"{regime}_{dev}.tsv"
        n0 = dict(bj._cuda.LAUNCHES)
        assert cli.main(["profile", db, smp, "-c", "1", "--device", dev,
                         "-o", str(out)]) == 0
        if dev == "cuda" and regime != "merge":
            assert bj._cuda.LAUNCHES["B1_fill"] > n0.get("B1_fill", 0)
        tsv[regime, dev] = out.read_text()
    want = tsv["merge", "cuda"]
    assert {r.split("\t")[1] for r in want.splitlines()[1:]} == planted
    for key, got in tsv.items():
        assert got == want, key


# ---- several devices: two logical devices sharing the card -----------------

def test_grange_two_devices_match_plain(cuda):
    """The grange dry run's world (heavy runs, forced spill) on [cuda:0,
    cuda:0]: chunks round-robin over the two devices, a conservation fetch
    and a bincount a device; equal to the engine's plain-kernel CPU run and
    to the numpy oracle, and two process spans on the card sum to it. B1
    and the compare launch once a chunk."""
    from sylph_tpu_torch import multichip
    kmers, gids, sk, sc = multichip.grange_world(1 << 14, 4)
    idx = gr.build_grange_index(kmers, gids, 40, chunk_slots=1 << 14,
                                device=cuda, **multichip.GRANGE_BUILD)
    assert idx.n_heavy > 0 and idx.spill_kmers.size > 0
    two = [torch.device("cuda", 0)] * 2
    want = gr.GRangeEngine(idx, device="cpu").hists(sk, sc)
    np.testing.assert_array_equal(
        want, multichip.oracle_hists(kmers, gids, 40, sk, sc))
    n0 = dict(bj._cuda.LAUNCHES)
    got = gr.GRangeEngine(idx, devices=two).hists(sk, sc)
    np.testing.assert_array_equal(got, want)
    d = {k: bj._cuda.LAUNCHES[k] - n0[k] for k in n0}
    n = len(idx.chunk_keys)
    assert d["B1_fill"] == n
    assert d["B2_join_codes_compact"] + d["B4_join_codes"] == n
    parts = [gr.GRangeEngine(idx, devices=two, process_span=(i, 2)).hists(
        sk, sc) for i in range(2)]
    np.testing.assert_array_equal(parts[0] + parts[1], want)


def test_sharded_merge_join_two_devices_matches_plain(cuda):
    """DeviceContainment on [cuda:0, cuda:0] below GRANGE_MIN: the index in
    two shards on the card, counts (one sample and a batched prefetch)
    equal to the one-device CPU engine's."""
    from sylph_tpu_torch.core.types import GenomeSketch, SequencesSketch
    from sylph_tpu_torch.engine.device_exec import DeviceContainment
    rng = np.random.default_rng(7)
    pool = rng.integers(0, 1 << 62, size=40_000, dtype=np.uint64)
    genomes = [GenomeSketch(rng.choice(pool, size=3000, replace=False),
                            None, f"g{g}", f"c{g}", 100, 31, 300_000, 30)
               for g in range(24)]
    samples = []
    for s in range(3):
        skm = np.unique(rng.choice(pool, size=9000 + 1000 * s))
        samples.append(SequencesSketch(
            skm, rng.integers(1, 9, size=skm.size).astype(np.uint32), 100,
            31, f"s{s}"))
    one = DeviceContainment(genomes, device="cpu")
    sh = DeviceContainment(genomes, devices=[torch.device("cuda", 0)] * 2)
    assert sh._shards is not None and all(
        t.device.type == "cuda" for t in sh._shards)
    got = sh._counts(samples[0])
    want = one._counts(samples[0])
    n = min(got.size, want.size)
    np.testing.assert_array_equal(got[:n], want[:n])
    assert not got[n:].any() and not want[n:].any()
    sh.prefetch(samples[1:])
    assert sh.counters == {"batched_joins": 1, "sharded_joins": 2}
    for s in samples[1:]:
        g, w = sh._counts(s), one._counts(s)
        np.testing.assert_array_equal(g[:n], w[:n])


# ---- the bench's synthetic index and entry() (gpu/synth_index.py) ---------

@pytest.mark.parametrize("nt,dup", [(1, False), (4, False), (4, True)])
def test_synth_index_on_card_matches_cpu(cuda, nt, dup):
    """The synthetic index made on the card equals its CPU generation and
    the host replay of chunk 0, field for field."""
    from sylph_tpu_torch.gpu import synth_index as si
    kw = dict(chunk_slots=1 << 15, target_mean=256, nt=nt)
    G, KPG = 60, 2000
    spec = (lambda: si.DupSpec(hf=0.5, r=4, lbase=20, lmod=16)) if dup \
        else (lambda: None)
    d_cpu, d_card = spec(), spec()
    a = si.synth_index_device(G, KPG, 50, device="cpu", dup=d_cpu, **kw)
    b = si.synth_index_device(G, KPG, 50, device="cuda", dup=d_card, **kw)
    assert len(a.chunk_keys) == len(b.chunk_keys) >= 2
    for ka, ga, kb, gb in zip(a.chunk_keys, a.chunk_gid, b.chunk_keys,
                              b.chunk_gid):
        assert kb.device.type == "cuda"
        assert torch.equal(ka, kb.cpu()) and torch.equal(ga, gb.cpu())
    for f in ("m", "B", "CI", "width", "nt", "ov", "n_heavy"):
        assert getattr(a, f) == getattr(b, f), f
    (hk, hg), = si.synth_chunks_host(G, KPG, 50, dup=d_cpu, chunks=[0],
                                     **kw)
    np.testing.assert_array_equal(hk, b.chunk_keys[0].cpu().numpy())
    np.testing.assert_array_equal(hg, b.chunk_gid[0].cpu().numpy())
    pa = si.synth_plants_host(G, KPG, 50, per_chunk=512, gid_max=None,
                              dup=d_cpu, device="cpu", **kw)
    pb = si.synth_plants_host(G, KPG, 50, per_chunk=512, gid_max=None,
                              dup=d_card, device="cuda", **kw)
    np.testing.assert_array_equal(pa[0], pb[0])
    np.testing.assert_array_equal(pa[1], pb[1])


def test_inverse_hash_on_card_matches_numpy(cuda):
    from sylph_tpu_torch.gpu import synth_index as si
    from sylph_tpu_torch.kmer.hashing import inv_mm_hash64_np
    x = np.random.default_rng(9).integers(0, 2 ** 64, size=1 << 16,
                                          dtype=np.uint64)
    got = si.inv_mm_hash64(torch.from_numpy(x.view(np.int64)).cuda())
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64),
                                  inv_mm_hash64_np(x))


def test_expand_markers_on_card_matches_cpu(cuda):
    from sylph_tpu_torch.gpu import synth_index as si
    G, n_heavy, H = 40, 300, 64
    rng = np.random.default_rng(3)
    hist = np.zeros((G + n_heavy) * H + 1, np.int64)
    hist[:G * H] = rng.integers(0, 3, size=G * H)
    rows = rng.choice(n_heavy, size=50, replace=False)
    hist[G * H + rows * H + rng.integers(1, H, size=50)] = 1
    h = torch.from_numpy(hist)
    for caps in ((64, 1 << 14), (20, 1 << 14), (64, 100)):
        a, oka = si.expand_markers_device(h, G=G, n_heavy=n_heavy,
                                          runs_cap=caps[0],
                                          entries_cap=caps[1], lbase=20,
                                          lmod=16)
        b, okb = si.expand_markers_device(h.cuda(), G=G, n_heavy=n_heavy,
                                          runs_cap=caps[0],
                                          entries_cap=caps[1], lbase=20,
                                          lmod=16)
        assert torch.equal(a, b.cpu()) and bool(oka) == bool(okb)


def test_entry_on_card_matches_cpu(cuda):
    """multichip.entry() on the card (B6 and the merge join) against its
    plain run on the CPU: the histogram exactly, ANI and coverage within
    rtol 1e-5."""
    from sylph_tpu_torch.gpu import _cuda
    from sylph_tpu_torch.multichip import entry
    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    n0 = _cuda.LAUNCHES["B6_seed_pack"]
    h, ani, cov = fn(*args)
    assert _cuda.LAUNCHES["B6_seed_pack"] == n0 + 1
    fc, ac = entry(device="cpu")
    hc, anic, covc = fc(*ac)
    assert torch.equal(h.cpu(), hc) and int(hc[:, 1:].sum()) > 0
    np.testing.assert_allclose(ani.cpu().numpy(), anic.numpy(), rtol=1e-5)
    np.testing.assert_allclose(cov.cpu().numpy(), covc.numpy(), rtol=1e-5)


# ---- the dev tools on the card ---------------------------------------------

@pytest.mark.parametrize("nt", ["1", "4"])
def test_gbench_variants_on_card(cuda, monkeypatch, nt):
    """gbench at a small size on the card: every variant's histogram equals
    full's, full's the oracle, and joinstages launches B5 once a chunk in
    its +compare line."""
    import functools

    from sylph_tpu_torch import gbench
    from sylph_tpu_torch.gpu import synth_index as si
    kw = dict(chunk_slots=1 << 18, target_mean=256)
    monkeypatch.setattr(si, "synth_index_device", functools.partial(
        si.synth_index_device, **kw))
    monkeypatch.setattr(si, "synth_plants_host", functools.partial(
        si.synth_plants_host, **kw))
    monkeypatch.setenv("SYLPH_NT", nt)
    out = gbench.run(genomes=400, reps=1, batches=4, reads=4096, kpg=2000,
                     device=cuda, variants=[
                         "prefix", "joinonly", "joinstages", "dense75",
                         "fill", "seed_t", "fused2"])
    assert out["checks"]["oracle_hits"] > 0
    for tag in ("full", "joinonly", "join:+compare", "join:+codes",
                "full(d0.75)", "full(seed_t)", "full(x2)"):
        assert out["checks"][tag] == "equal", tag
    n_chunks = out["index"]["chunks"]
    assert out["lines"]["join:+compare"]["launches"]["B5_join_counts"] == \
        n_chunks
    assert out["lines"]["seed(seed_t)"]["launches"].get("B9_seed_pack_t")
    assert out["lines"]["seed"]["launches"]["B6_seed_pack"] == 4


def test_dupskew_parity_on_card(cuda):
    from sylph_tpu_torch import dupskew
    # whole chunks of 16 buckets at the GTDB chunks' mean (the uniform
    # index is exactly 8 chunks)
    recs = dupskew.run(1 << 17, 2000, "uniform,a2.0:d1000,a1.2:d300",
                       (1, 4), 50_000, 1 << 14, cuda, reps=1)
    assert len(recs) == 6
    assert all(r["parity"] == "OK" and r["dparity"] == "OK" for r in recs)
    assert any(r["spill"] for r in recs) and any(r["heavy"] for r in recs)


# ---- the stream sweep replayed from a CUDA graph ----------------------------

def _stream_world(cuda, seed=90, G=60, m=200_000):
    """A tiled grange index on the card with no heavy runs, and its
    samples: (int64 keys in uint64 order, uint8 weights) on the card, t
    distinct keys, half of them from the index."""
    rng = np.random.default_rng(seed)
    thr = ((1 << 64) - 1) // 20
    kmers = rng.integers(0, thr, size=m, dtype=np.uint64)
    gids = rng.integers(0, G, size=m).astype(np.int32)
    idx = gr.build_grange_index(kmers, gids, G, chunk_slots=1 << 15,
                                target_mean=512, nt=4, device=cuda)
    assert idx.n_heavy == 0 and len(idx.chunk_keys) > 2

    def sample(t, s):
        r = np.random.default_rng(s)
        sk = np.unique(np.concatenate([
            r.choice(kmers, size=t // 2),
            r.integers(0, thr, size=t - t // 2, dtype=np.uint64)]))
        sc = r.integers(1, 90, size=sk.size)
        return (torch.from_numpy(sk.view(np.int64)).to(cuda),
                torch.from_numpy(np.minimum(sc, 63).astype(np.uint8)
                                 ).to(cuda))
    return idx, sample


def test_stream_graph_replays_match_eager(cuda, monkeypatch):
    """Replayed stream sweeps give the eager sweep's histograms, probes and
    slice lengths bit for bit, over samples of two static buffer lengths
    and the retry at 8 lanes more; one capture a shape."""
    idx, sample = _stream_world(cuda)
    graph = gr.GRangeEngine(idx, device=cuda)
    eager = gr.GRangeEngine(idx, device=cuda)
    monkeypatch.setattr(eager, "_graph_ready", lambda: False)
    assert graph._graph_ready()
    shapes, calls = set(), 0
    for t, seed in ((3000, 1), (7000, 2), (3000, 3), (2900, 4), (7000, 5)):
        skey, w = sample(t, seed)
        cs = graph.plan_stream(int(skey.shape[0]))[1]
        for c in (None, cs + 8):
            got = graph.hist_device_stream(skey, w, cs=c)
            want = eager.hist_device_stream(skey, w, cs=c)
            assert torch.equal(got[0], want[0]), (t, seed, c)
            assert torch.equal(got[1], want[1]) and got[2] == want[2]
            assert int(want[1][0]) == 0 and want[0][:-1].sum() > 0
            shapes.add(graph.sweep_shape(int(skey.shape[0]), cs=c))
            calls += 1
    assert len({s.Tcap for s in shapes}) >= 2
    assert graph.counters["stream_graph_captures"] == len(shapes) < calls
    assert graph.counters["stream_graph_replays"] == calls - len(shapes)
    assert graph.counters["stream_eager_sweeps"] == 0
    assert eager.counters["stream_eager_sweeps"] == calls
    assert eager.counters["stream_graph_captures"] == 0


def test_stream_graph_results_are_not_aliased(cuda):
    """A result stays intact after the next call replays the same graph
    into the same static buffers."""
    idx, sample = _stream_world(cuda)
    eng = gr.GRangeEngine(idx, device=cuda)
    a, b = sample(3000, 11), sample(3000, 12)
    assert eng.sweep_shape(int(a[0].shape[0])) == \
        eng.sweep_shape(int(b[0].shape[0]))
    h1, p1, _ = eng.hist_device_stream(*a)
    keep_h, keep_p = h1.clone(), p1.clone()
    h2, _p2, _ = eng.hist_device_stream(*b)
    torch.cuda.synchronize()
    assert eng.counters["stream_graph_captures"] == 1
    assert torch.equal(h1, keep_h) and torch.equal(p1, keep_p)
    assert not torch.equal(h1, h2)


def test_stream_graph_counts_one_capture_then_replays(cuda):
    """The first call runs eagerly, returns that result and captures;
    later calls replay. Each call counts the launches of one eager sweep
    (a fill a chunk): the capture's own launches run nowhere."""
    idx, sample = _stream_world(cuda)
    eng = gr.GRangeEngine(idx, device=cuda)
    skey, w = sample(3000, 21)
    n = len(idx.chunk_keys)
    launched = []
    for _ in range(3):
        n0 = dict(bj._cuda.LAUNCHES)
        eng.hist_device_stream(skey, w)
        launched.append({k: v - n0[k] for k, v in bj._cuda.LAUNCHES.items()
                         if v != n0[k]})
    assert launched[0]["B1_fill"] == n
    assert launched[0] == launched[1] == launched[2]
    assert eng.counters["stream_graph_captures"] == 1
    assert eng.counters["stream_graph_replays"] == 2
    assert eng.counters["stream_eager_sweeps"] == 0


def test_stream_sweep_stays_eager_with_chunks_not_resident(cuda):
    """An engine that holds fewer chunks than the index has uploads chunks
    inside the loop, so its stream sweep runs eagerly, with the same
    result as a replay."""
    idx, sample = _stream_world(cuda)
    part = gr.GRangeEngine(idx, device=cuda, max_resident_chunks=1)
    full = gr.GRangeEngine(idx, device=cuda)
    assert not part._graph_ready() and full._graph_ready()
    skey, w = sample(3000, 31)
    got = part.hist_device_stream(skey, w)
    want = full.hist_device_stream(skey, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert part.counters["stream_eager_sweeps"] == 1
    assert part.counters["stream_graph_captures"] == 0
    assert full.counters["stream_graph_captures"] == 1


def test_stream_graph_replay_does_not_sync(cuda):
    """A replayed sweep of a folded sample raises nothing under
    set_sync_debug_mode("error"): no call blocks the host."""
    idx, sample = _stream_world(cuda)
    eng = gr.GRangeEngine(idx, device=cuda)
    skey, w = sample(3000, 41)
    want = eng.hist_device_stream(skey, w)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eng.hist_device_stream(skey, w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert eng.counters["stream_graph_replays"] == 1


def test_stream_graph_cache_full_runs_new_shapes_eagerly(cuda, monkeypatch):
    """With _GRAPHS_MAX graphs kept, a sample of a new shape runs eagerly
    and is not captured, and the kept shapes go on replaying; the engine's
    graph buffers are one input pair a captured Tcap and the outputs."""
    monkeypatch.setattr(gr, "_GRAPHS_MAX", 1)
    idx, sample = _stream_world(cuda)
    eng = gr.GRangeEngine(idx, device=cuda)
    eager = gr.GRangeEngine(idx, device=cuda)
    monkeypatch.setattr(eager, "_graph_ready", lambda: False)
    a, b = sample(3000, 81), sample(7000, 82)
    sa, sb = (eng.sweep_shape(int(x[0].shape[0])) for x in (a, b))
    assert sa != sb
    for x in (a, b, a, b):
        got, want = eng.hist_device_stream(*x), eager.hist_device_stream(*x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    c = eng.counters
    assert (c["stream_graph_captures"], c["stream_graph_replays"],
            c["stream_eager_sweeps"]) == (1, 1, 2)
    assert list(eng._graphs) == [sa]
    nbytes = sum(t.numel() * t.element_size() for t in eng.graph_buffers())
    assert nbytes == sa.Tcap * 12 + (eng._GE * 64 + gr.SENT_BINS) * 8 + 16


def test_stream_graph_capture_does_not_sync(cuda, monkeypatch):
    """The first sweep of a shape, which runs eagerly and captures its
    graph, raises nothing under set_sync_debug_mode("error"): the capture
    neither synchronizes the device nor empties the allocator's cache."""
    idx, sample = _stream_world(cuda)
    warm = gr.GRangeEngine(idx, device=cuda)
    monkeypatch.setattr(warm, "_graph_ready", lambda: False)
    skey, w = sample(3000, 61)
    want = warm.hist_device_stream(skey, w)      # builds the kernels
    eng = gr.GRangeEngine(idx, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eng.hist_device_stream(skey, w)
        again = eng.hist_device_stream(skey, w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g in (got, again):
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
    assert eng.counters["stream_graph_captures"] == 1
    assert eng.counters["stream_graph_replays"] == 1


def test_stream_graph_capture_counts_exactly_with_another_thread(cuda,
                                                               monkeypatch):
    """Another thread sweeps eagerly in the middle of a capture (as the
    CLI's loaders launch kernels while a sample is swept): its launches
    count in the launch counts as they ran, the graph holds only its own,
    and the capture and the other thread's sweep both stay exact."""
    idx, sample = _stream_world(cuda)
    eng = gr.GRangeEngine(idx, device=cuda)
    other = gr.GRangeEngine(idx, device=cuda)
    monkeypatch.setattr(other, "_graph_ready", lambda: False)
    skey, w = sample(3000, 71)
    want = other.hist_device_stream(skey, w)
    n = len(idx.chunk_keys)
    go, done, got_other = threading.Event(), threading.Event(), []

    def sweep_in_thread():
        go.wait(60)
        got_other.append(other.hist_device_stream(skey, w))
        done.set()

    sweep = eng._stream_sweep
    during = []

    def stream_sweep(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            go.set()
            during.append(done.wait(60))
        return sweep(*a, **kw)
    monkeypatch.setattr(eng, "_stream_sweep", stream_sweep)
    th = threading.Thread(target=sweep_in_thread)
    th.start()
    n0 = dict(bj._cuda.LAUNCHES)
    got = eng.hist_device_stream(skey, w)
    th.join(60)
    assert during == [True] and not th.is_alive()
    delta = {k: v - n0[k] for k, v in bj._cuda.LAUNCHES.items()
             if v != n0[k]}
    assert delta["B1_fill"] == 2 * n           # the eager pass + the thread
    (graph, held), = eng._graphs.values()
    assert held["B1_fill"] == n
    assert {k: 2 * v for k, v in held.items()} == delta
    n0 = dict(bj._cuda.LAUNCHES)
    again = eng.hist_device_stream(skey, w)
    assert {k: v - n0[k] for k, v in bj._cuda.LAUNCHES.items()
            if v != n0[k]} == held
    for g in (got, got_other[0], again):
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
    assert eng.counters["stream_graph_replays"] == 1


def test_bucket_engine_on_card_matches_cpu_syncing_only_in_the_fold(
        cuda, monkeypatch):
    """The bucket regime's engine (BucketEngine.hist_device_stream) over
    four chunks gives the CPU path's histogram and probe bit for bit, at
    H = 64 and 256 and at a sample capacity too small for the sample; and
    under set_sync_debug_mode("error") the call's only host syncs are the
    fold's two named waits (each let through, and recorded, by a stand-in
    for ``wait``)."""
    import contextlib

    from sylph_tpu_torch.gpu.containment import build_host_index
    rng = np.random.default_rng(5)
    c, G, kpg, chunk = 200, 30, 2000, 1 << 14
    thr = ((1 << 64) - 1) // c
    keys = rng.permutation(np.unique(rng.integers(
        0, thr, size=2 * G * kpg, dtype=np.uint64)))[:G * kpg]
    genomes = [keys[g * kpg:(g + 1) * kpg] for g in range(G)]
    index = build_host_index(genomes, pad_multiple=bj.padded_slots(
        G * kpg, chunk))
    cpu = bj.BucketEngine(index, c, chunk=chunk, device="cpu")
    card = bj.BucketEngine(index, c, chunk=chunk, device=cuda)
    assert len(card.chunks) == 4
    occ = np.concatenate(
        [np.repeat(genomes[g], rng.poisson(lam, size=kpg))
         for g, lam in ((3, 0.4), (11, 5.0), (29, 120.0))]
        + [rng.integers(0, thr, size=20000, dtype=np.uint64)]).view(np.int64)
    stream = torch.from_numpy(rng.permutation(
        np.concatenate([occ, np.full(999, -1, np.int64)])))
    waits = []

    @contextlib.contextmanager
    def named(name):
        waits.append(name)
        torch.cuda.set_sync_debug_mode("default")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("error")

    for H, cs in ((64, None), (256, None), (256, 8)):
        want = cpu.hist_device_stream(stream, n_buckets=H, cs=cs)
        on = stream.to(cuda)
        card.hist_device_stream(on, n_buckets=H, cs=cs)     # builds, warms
        torch.cuda.synchronize()
        waits.clear()
        with monkeypatch.context() as m:
            m.setattr(gr, "wait", named)
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = card.hist_device_stream(on, n_buckets=H, cs=cs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert waits == ["fold.mask", "fold.unique"]
        _equal(got, want)
        assert (int(want[1]) > 0) == (cs == 8)
        assert int(want[0][:, 1:].sum()) > 0
    assert card.counters == {"stream_hists": 6, "chunk_joins": 24,
                             "refills": 0}
