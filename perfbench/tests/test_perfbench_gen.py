"""The benchmark's generators: the grange index's flat view against its
layout, the layout against the port's generator it was copied from, and
planted reads against the plants."""

import numpy as np
import pytest
import torch

from perfbench.gen import grange_index as gi
from perfbench.gen import hashing, reads
from perfbench.gen.index import FlatIndex
from perfbench.reference import sketch as ref_sketch

SIZES = [(64, 2048, 1 << 14), (300, 2048, 1 << 17)]


@pytest.mark.parametrize("plantable", [0, 40])
@pytest.mark.parametrize("nt", [1, 4])
@pytest.mark.parametrize("G,KPG,slots", SIZES)
def test_flat_view_equals_layout(G, KPG, slots, nt, plantable):
    """Every live (key, gid) of a chunk's layout, and nothing else, is in
    the flat view of its buckets; the layout fills a bucket's counted
    cells; every key of a plantable genome is usable."""
    geo = gi.geometry(G, KPG, 200, slots, 1024, nt, plantable)
    for i in range(geo.n_chunks):
        keys, gids = gi.chunk_layout(geo, i, "cpu")
        live = keys != gi.KEY_PAD
        assert torch.equal(gids[~live], torch.full_like(gids[~live], G))
        lay = torch.sort(keys[live] * G + gids[live].to(torch.int64)).values
        parts = [gi.flat_block(geo, i, r0, min(geo.B, r0 + 7), "cpu")
                 for r0 in range(0, geo.B, 7)]
        fk = torch.cat([k for k, _ in parts])
        fg = torch.cat([g for _, g in parts])
        assert torch.equal(lay, torch.sort(fk * G + fg).values)
        assert int(live.sum()) == int(gi.cell_counts(
            geo, i, 0, geo.B, "cpu").sum())
        lo, hi = geo.edges(i)
        u = fk.numpy().view(np.uint64)
        assert u.min() >= lo and u.max() <= hi
        assert bool(hashing.usable(fk[fg < plantable]).all())


@pytest.mark.parametrize("nt", [1, 4])
def test_layout_equals_the_port_generator(nt):
    """The frozen copy lays out the chunks the port's
    gpu/synth_index.py::synth_index_device makes, with its edges; with
    plantable genomes, only their unusable keys differ, each redrawn in
    its own bucket and sub-range."""
    synth = pytest.importorskip("sylph_tpu_torch.gpu.synth_index")
    G, KPG, slots = 300, 2048, 1 << 17
    idx = synth.synth_index_device(G, KPG, 200, device="cpu",
                                   chunk_slots=slots, nt=nt)
    for plantable in (0, 50):
        geo = gi.geometry(G, KPG, 200, slots, 1024, nt, plantable)
        assert (geo.n_chunks, geo.B, geo.CI, geo.width) == (
            len(idx.chunk_keys), idx.B, idx.CI, idx.width)
        for i in range(geo.n_chunks):
            keys, gids = gi.chunk_layout(geo, i, "cpu")
            port = idx.chunk_keys[i]
            assert torch.equal(gids, idx.chunk_gid[i])
            assert geo.edges(i) == tuple(int(e) for e in idx.edges_u64[i])
            assert geo.base(i) == int(idx.bases[i])
            live = port != gi.KEY_PAD
            moved = live & (gids < plantable) & ~hashing.usable(port)
            assert torch.equal(keys[~moved], port[~moved])
            assert bool((keys[moved] != port[moved]).all())
            assert bool(hashing.usable(keys[moved]).all())

            def cell(k):
                local = hashing.lsr(k, 32) - geo.base(i)
                return (local // geo.width,
                        (local % geo.width) // geo.subwidth)
            for a, b in zip(cell(keys[moved]), cell(port[moved])):
                assert torch.equal(a, b)
            assert bool(moved.any()) == (plantable > 0)


def test_gtdb_geometry():
    """GTDB-R220 at 12,288 k-mers a genome: 42 chunks of [32768, 1152],
    4 tiles, about 88% live, 19.0 GB of keys and genome ids."""
    geo = gi.geometry(113104, 12288, 200, 1 << 25, 1024, 4)
    assert (geo.n_chunks, geo.B, geo.CI, geo.nt, geo.tile) == (
        42, 32768, 1152, 4, 256)
    assert 42 * 32768 * 1152 * 12 == 19_025_362_944


def test_hash_inverse_and_usable():
    g = torch.Generator().manual_seed(3)
    v = torch.randint(0, 1 << 62, (4096,), generator=g)
    h = hashing.mm_hash64(v)
    assert torch.equal(hashing.inv_mm_hash64(h), v)
    rc = hashing.rc31(v)
    assert torch.equal(hashing.rc31(rc), v)
    canon = torch.minimum(v, rc)
    assert bool(hashing.usable(hashing.mm_hash64(canon)).all())


TRAFFIC = {"read_len": 150, "row_len": 256, "present_genomes": 3,
           "coverage": [0.5, 1.0, 4.0], "filler_rows": 4096}


def _plan(n_reads, seed=11):
    idx = FlatIndex({"genomes": 16, "kmers_per_genome": 1024, "c": 200,
                     "k": 31, "index_seed": 5}, "cpu")
    pl = reads.plantable(idx)
    gen = torch.Generator().manual_seed(seed)
    filler = reads.filler_rows(TRAFFIC, 200, gen)
    plan = reads.sample_plan(pl, n_reads, TRAFFIC, 200, gen)
    return pl, plan, reads.reads_with(*plan, filler, TRAFFIC, gen)


def test_planted_reads_carry_their_plants():
    """Every plant's hash is in the sample's reference sketch at least as
    many times as it was planted, and every kept hash of a read window is
    below u64::MAX / c."""
    pl, (plants, row, off, present), packed = _plan(16384)
    assert bool(hashing.usable(pl.keys).all())
    assert packed.shape == (16384, 16) and packed.dtype == torch.int32
    codes = ref_sketch.unpack(packed, 256)
    assert bool((codes[:, 150:] == 0).all())
    assert bool(present[row].all()) and int(off.max()) + 31 <= 150
    lengths = torch.full((16384,), 150, dtype=torch.int32)
    sk, cnt = ref_sketch.sketch_sample(packed[None], lengths, c=200, k=31)
    pk, pc = torch.unique(plants, return_counts=True)
    pos = torch.searchsorted(sk, pk)
    assert bool((sk[pos] == pk).all())
    assert bool((cnt[pos] >= pc).all())
    assert bool(hashing.u64_lt(sk, hashing.threshold(200)).all())


def test_plants_come_at_the_fracminhash_rate():
    """A present genome's read carries about (150 - 31 + 1) / 200 = 0.6 of
    its k-mers, and a k-mer about coverage * 120 / 150 copies; a
    background read carries none; the filler rows keep no window, so a
    present read keeps little besides its plants."""
    n = 16384
    pl, (plants, row, off, present), packed = _plan(n, seed=12)
    n_present = int(present.sum())
    # 3 genomes of about 1,024 k-mers at 0.5, 1 and 4: 5.5 * 1024 * 200
    # / 150 reads
    assert abs(n_present - 5.5 * 1024 * 200 / 150) < 40
    rate = plants.numel() / n_present
    assert 0.55 < rate < 0.65
    per_read = torch.bincount(row, minlength=n)
    assert int(per_read[~present].sum()) == 0
    assert int(per_read.max()) <= 150 // 31
    h, keep = ref_sketch.window_hashes(
        packed, torch.full((n,), 150, dtype=torch.int32), c=200, k=31)
    kept_present = int(keep[present].sum())
    assert kept_present < 1.5 * plants.numel()
    kept_bg = float(keep[~present].sum()) / int((~present).sum())
    assert 0.5 < kept_bg < 0.7


def test_pool_is_seeded():
    idx = FlatIndex({"genomes": 16, "kmers_per_genome": 4096, "c": 200,
                     "k": 31, "index_seed": 5}, "cpu")
    traffic = {"read_len": 150, "row_len": 256, "present_genomes": 2,
               "coverage": [0.05], "reads_per_batch": 512, "batches": 2,
               "pool_samples": 2, "filler_rows": 1024}
    a = reads.make_pool(idx, traffic, 2**31 + 9, "cpu")
    b = reads.make_pool(idx, traffic, 2**31 + 9, "cpu")
    c = reads.make_pool(idx, traffic, 2**31 + 10, "cpu")
    assert torch.equal(a.packed, b.packed)
    assert not torch.equal(a.packed, c.packed)
    assert not torch.equal(a.packed[0], a.packed[1])
    assert a.bases == 2 * 512 * 150
