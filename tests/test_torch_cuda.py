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


@pytest.mark.parametrize("k", [9, 15])
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
