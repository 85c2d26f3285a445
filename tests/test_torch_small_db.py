"""The port's merge and bucket regimes against the JAX package on the CPU.

- ``merge_join_counts`` against the JAX merge join on seeded tables with
  pads and weights; the -1 pads of the port's int64 table never count.
- The bucket regime's layout and join: ``build_bucketed_index`` on live
  k-mers equals the JAX package's; the plain ``bucket_join_device`` (the
  plain B1 fill and the plain compare) equals the JAX
  ``bucket_join_device`` in Pallas interpret mode, grid for grid; a padded
  tail chunk keeps CI within one 128-lane step of a full chunk's (the JAX
  layout buckets its pads and does not); a tiny tail chunk against a large
  sample keeps its lane width inside the compare kernel's limit; B < 64
  (one block of TB = B rows).
- ``DeviceContainment`` in both regimes (BUCKET_MIN and CHUNK patched, as
  tests/test_device_chunking.py does): ``genome_covs`` and ``hists`` equal
  the JAX engine's and the host probe's, with and without a winner table.
- CLI TSVs byte-identical to the JAX host engine in the merge regime (no
  patch) and the bucket regime (BUCKET_MIN, CHUNK patched), for .sylsp
  samples and raw reads (single and -1/-2).

All comparisons are exact (integers, bytes); inputs come from numpy seeds.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.core.types import GenomeSketch as JGenome
from sylph_tpu.core.types import SequencesSketch as JSample
from sylph_tpu.engine.containment import WinnerTable as JWinner
from sylph_tpu.engine.device_exec import DeviceContainment as JDC
from sylph_tpu.engine.runner import ContainOptions, contain
from sylph_tpu.tpu import bucket_join as jbj
from sylph_tpu.tpu.containment import merge_join_counts as j_merge
from sylph_tpu.tpu.u64 import from_u64_np
from sylph_tpu_torch import cli
from sylph_tpu_torch.core.types import GenomeSketch, SequencesSketch
from sylph_tpu_torch.engine import runner
from sylph_tpu_torch.engine.containment import WinnerTable, genome_covs
from sylph_tpu_torch.engine.device_exec import DeviceContainment
from sylph_tpu_torch.gpu import bucket_join as tbj
from sylph_tpu_torch.gpu.containment import (build_host_index,
                                             merge_join_counts)
from sylph_tpu_torch.gpu.keys import from_pair_np
from tests.test_torch_cli import _TF, ecoli_db, world  # noqa: F401

torch.set_num_threads(1)
CPU = torch.device("cpu")
SENT = np.uint32(0xFFFFFFFF)


def _keys(rng, n, c):
    return rng.integers(0, ((1 << 64) - 1) // c, size=n, dtype=np.uint64)


# ---- merge join ------------------------------------------------------------

@pytest.mark.parametrize("seed,M,T", [(0, 5000, 3000), (1, 20000, 700),
                                      (2, 3000, 9000)])
def test_merge_join_counts_matches_jax(seed, M, T):
    """Index with zero pads, a SENT/-1-padded sample with repeats and
    weights: the same [M] counts."""
    rng = np.random.default_rng(seed)
    idx = _keys(rng, M, 20)
    idx[-M // 10:] = 0                                    # index pads
    smp = np.concatenate([rng.choice(idx[:-M // 10], size=T // 2),
                          _keys(rng, T - T // 2, 20)])
    w = rng.integers(0, 9, size=T).astype(np.int32)
    pad = 1024
    shi, slo = from_u64_np(smp)
    shi = np.concatenate([shi, np.full(pad, SENT)])
    slo = np.concatenate([slo, np.full(pad, SENT)])
    w = np.concatenate([w, np.zeros(pad, np.int32)])
    ihi, ilo = from_u64_np(idx)
    want = np.asarray(jax.jit(j_merge)(ihi, ilo, shi, slo, w))
    got = merge_join_counts(torch.from_numpy(idx.view(np.int64)),
                            torch.from_numpy(from_pair_np(shi, slo)),
                            torch.from_numpy(w)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > T // 10


def test_merge_join_pads_never_count():
    """The -1 pads sort first in int64 (SENT sorts last in the JAX join);
    with weight 0 they count nothing, even against an index key of -1;
    without weights every occurrence counts 1."""
    idx = torch.tensor([-1, 5, 7, 0, 5], dtype=torch.int64)
    smp = torch.tensor([7, -1, 5, -1, 5, 9], dtype=torch.int64)
    w = torch.tensor([3, 0, 2, 0, 4, 1], dtype=torch.int32)
    assert merge_join_counts(idx, smp, w).tolist() == [0, 6, 3, 0, 6]
    assert merge_join_counts(idx, smp).tolist() == [2, 2, 1, 0, 2]


# ---- bucket layout and B5' -------------------------------------------------

def _sample_table(rng, idx, T, c, pad=512):
    """Sorted (int64 keys with a -1 tail, int32 weights) and its dict."""
    smp = np.unique(np.concatenate([rng.choice(idx, size=T // 2),
                                    _keys(rng, T // 2, c)]))
    wts = rng.integers(1, 7, size=smp.size).astype(np.int32)
    keys = np.concatenate([smp.view(np.int64), np.full(pad, -1, np.int64)])
    w = np.concatenate([wts, np.zeros(pad, np.int32)])
    return keys, w, smp.size, dict(zip(smp.tolist(), wts.tolist()))


def _probe(kmers, table):
    return np.array([table.get(int(k), 0) for k in kmers], np.int32)


@pytest.mark.parametrize("seed,M,c", [(0, 30000, 50), (1, 5000, 10),
                                      (2, 70000, 200)])
def test_build_bucketed_index_matches_jax(seed, M, c):
    idx = _keys(np.random.default_rng(seed), M, c)
    want = jbj.build_bucketed_index(*from_u64_np(idx), c)
    got = tbj.build_bucketed_index(idx.view(np.int64), c)
    assert (got.width, got.n_buckets, got.m) == (want.width,
                                                 want.n_buckets, want.m)
    np.testing.assert_array_equal(got.key.numpy(),
                                  from_pair_np(want.hi, want.lo))
    pos = np.full(got.key.shape, -1, np.int64)
    pos.reshape(-1)[got.src.numpy()] = np.arange(got.m)
    np.testing.assert_array_equal(pos, want.pos)


def test_bucket_join_device_plain_matches_pallas_interpret():
    """tests/test_bucket_join.py's Pallas case: the port's plain
    bucket_join_device gives the same [B, CI] grid, and bucket_join_counts
    the exact counts."""
    rng = np.random.default_rng(3)
    c = 50
    idx = _keys(rng, 20000, c)
    keys, w, t_real, table = _sample_table(rng, idx, 2000, c)
    jb = jbj.build_bucketed_index(*from_u64_np(idx), c)
    CS = jbj.sample_cs(t_real, jb.n_buckets)
    shi, slo = from_u64_np(keys.view(np.uint64))
    want = np.asarray(jbj.bucket_join_device(
        jnp.asarray(jb.hi), jnp.asarray(jb.lo), jnp.asarray(shi),
        jnp.asarray(slo), jnp.asarray(w), width=jb.width, B=jb.n_buckets,
        CS=CS, interpret=True))
    tb = tbj.build_bucketed_index(idx.view(np.int64), c)
    got = tbj.bucket_join_device(
        tb.key, torch.from_numpy(keys), torch.from_numpy(w), width=tb.width,
        B=tb.n_buckets, CS=CS).numpy()
    np.testing.assert_array_equal(got, want)
    counts = tbj.bucket_join_counts(tb, torch.from_numpy(keys),
                                    torch.from_numpy(w), t_real).numpy()
    np.testing.assert_array_equal(counts, _probe(idx, table))
    assert (counts > 0).sum() > 500


def test_padded_tail_chunk_ci():
    """A tail chunk holding half its slots' worth of k-mers: the port
    buckets only its live k-mers (B from the slot count), so CI stays
    within one 128-lane step of a full chunk's and the counts are the host
    probe's. The JAX layout buckets the zero pads as well; they all land
    in bucket 0 and set CI (8,320 here instead of 128)."""
    rng = np.random.default_rng(4)
    c, slots = 200, 16384
    full = _keys(rng, slots, c)
    tail = _keys(rng, slots // 2, c)
    bf = tbj.build_bucketed_index(full.view(np.int64), c)
    bt = tbj.build_bucketed_index(tail.view(np.int64), c, n_slots=slots)
    assert bt.n_buckets == bf.n_buckets == slots // 64
    assert bt.key.shape[1] <= bf.key.shape[1] + 128
    keys, w, t_real, table = _sample_table(rng, tail, 3000, c)
    got = tbj.bucket_join_counts(bt, torch.from_numpy(keys),
                                 torch.from_numpy(w), t_real).numpy()
    np.testing.assert_array_equal(got, _probe(tail, table))
    padded = np.concatenate([tail, np.zeros(slots - tail.size, np.uint64)])
    jb = jbj.build_bucketed_index(*from_u64_np(padded), c)
    assert jb.hi.shape[1] >= slots // 2
    assert bt.key.shape[1] * 32 < jb.hi.shape[1]


def test_tiny_tail_chunk_large_sample():
    """1,000 live k-mers in a 65,536-slot chunk against a 200,000-k-mer
    sample: B comes from the slots (1,024 buckets, 384 lanes) and not from
    the live count (16 buckets, about 12,600 lanes, past the compare
    kernel's 8,192 lanes a row); counts equal the host probe."""
    rng = np.random.default_rng(5)
    c = 50
    tail = _keys(rng, 1000, c)
    bt = tbj.build_bucketed_index(tail.view(np.int64), c, n_slots=1 << 16)
    keys, w, t_real, table = _sample_table(rng, tail, 400_000, c)
    CS = tbj.sample_cs(t_real, bt.n_buckets)
    assert bt.n_buckets == 1024 and CS <= tbj._JOIN_LANE_MAX
    assert tbj.sample_cs(t_real, 16) > tbj._JOIN_LANE_MAX
    got = tbj.bucket_join_counts(bt, torch.from_numpy(keys),
                                 torch.from_numpy(w), t_real).numpy()
    np.testing.assert_array_equal(got, _probe(tail, table))
    assert (got > 0).sum() > 100


@pytest.mark.parametrize("n_slots", [64, 1024, 2048])
def test_bucket_join_fewer_than_64_buckets(n_slots):
    """B = 1, 16, 32: one block of TB = B rows; exact counts."""
    rng = np.random.default_rng(n_slots)
    c = 30
    idx = _keys(rng, n_slots - 7, c)
    bt = tbj.build_bucketed_index(idx.view(np.int64), c, n_slots=n_slots)
    assert bt.n_buckets == n_slots // 64
    assert tbj.block_rows(bt.n_buckets) == bt.n_buckets
    keys, w, t_real, table = _sample_table(rng, idx, 900, c)
    got = tbj.bucket_join_counts(bt, torch.from_numpy(keys),
                                 torch.from_numpy(w), t_real).numpy()
    np.testing.assert_array_equal(got, _probe(idx, table))


def test_bucketed_index_src_gathers_chunk_order():
    """``src`` maps chunk position p to the grid slot holding k-mer p: one
    gather of the key grid returns the chunk in order, every other slot is
    a pad, and ``to`` carries both tensors."""
    rng = np.random.default_rng(6)
    idx = _keys(rng, 3000, 40)
    bt = tbj.build_bucketed_index(idx.view(np.int64), 40,
                                  n_slots=4096).to(CPU)
    flat = bt.key.reshape(-1)
    np.testing.assert_array_equal(flat[bt.src].numpy(), idx.view(np.int64))
    pad = torch.ones(flat.numel(), dtype=torch.bool)
    pad[bt.src] = False
    assert bool((flat[pad] == -1).all()) and int(pad.sum()) == \
        flat.numel() - 3000
    assert bt.src.dtype == torch.int64 and bt.m == 3000


def test_build_host_index_matches_jax():
    from sylph_tpu.tpu.pipeline import build_host_index as j_build
    rng = np.random.default_rng(7)
    arrs = [_keys(rng, n, 30) for n in (40, 0, 333, 17)]
    want = j_build(arrs, pad_multiple=128)
    got = build_host_index(arrs, pad_multiple=128)
    np.testing.assert_array_equal(got.keys, from_pair_np(want.hi, want.lo))
    np.testing.assert_array_equal(got.genome_ids, want.genome_ids)
    np.testing.assert_array_equal(got.n_kmers, want.n_kmers)
    assert got.n_genomes == want.n_genomes == 4


# ---- DeviceContainment -----------------------------------------------------

def _engine_world(seed, c=50):
    """tests/test_device_chunking.py's world, with a sample carrying
    every repeat weight and absent k-mers."""
    rng = np.random.default_rng(seed)
    pool = _keys(rng, 6000, c)
    kms = [rng.choice(pool, size=900, replace=False).astype(np.uint64)
           for _ in range(10)]
    skm = rng.choice(pool, size=2500, replace=False).astype(np.uint64)
    scnt = rng.integers(1, 6, size=2500).astype(np.uint32)
    args = dict(c=c, k=31, gn_size=1, min_spacing=30)
    jg = [JGenome(genome_kmers=k, pseudotax_tracked_nonused_kmers=None,
                  file_name=f"g{i}", first_contig_name=f"c{i}", **args)
          for i, k in enumerate(kms)]
    tg = [GenomeSketch(genome_kmers=k, pseudotax_tracked_nonused_kmers=None,
                       file_name=f"g{i}", first_contig_name=f"c{i}", **args)
          for i, k in enumerate(kms)]
    sargs = dict(c=c, k=31, file_name="s", sample_name=None, paired=False,
                 mean_read_length=150.0)
    js = JSample(kmers=skm, counts=scnt, **sargs)
    ts = SequencesSketch(kmers=skm, counts=scnt, **sargs)
    # a winner table over a third of the pool, three groups
    wk = np.sort(rng.choice(pool, size=2000, replace=False))
    wg = rng.integers(0, 3, size=wk.size).astype(np.int64)
    return jg, tg, js, ts, (wk, wg)


@pytest.mark.parametrize("regime", ["merge", "bucket"])
def test_device_containment_regimes_match_jax(regime, monkeypatch):
    for cls in (JDC, DeviceContainment):
        monkeypatch.setattr(cls, "CHUNK", 4096)
        if regime == "bucket":
            monkeypatch.setattr(cls, "BUCKET_MIN", 1000)
    jg, tg, js, ts, (wk, wg) = _engine_world(3)
    jeng = JDC(jg, devices=[jax.devices("cpu")[0]])
    teng = DeviceContainment(tg, device="cpu")
    assert teng._use_buckets == (regime == "bucket") == jeng._use_buckets
    if regime == "bucket":
        assert len(teng._bchunks) == 3
    else:
        assert tuple(teng._index_dev.shape) == (3 * 4096,)
    assert not teng.serves_streams() and teng.sample_streamer() is None
    assert teng.candidates_mask(ts, {}) is None
    np.testing.assert_array_equal(teng.hists(ts), jeng.hists(js))
    jw, tw = JWinner(wk, wg), WinnerTable(wk, wg)
    n_hit = 0
    for gi in range(len(tg)):
        for winner, group in ((None, -1), (tw, gi % 3)):
            got = teng.genome_covs(gi, ts, winner, group)
            want = jeng.genome_covs(gi, js, jw if winner else None, group)
            host = genome_covs(tg[gi], ts, winner, group)
            for other in (want, host):
                np.testing.assert_array_equal(got[0], other[0])
                assert got[0].dtype == other[0].dtype == np.uint32
                assert got[1] == other[1]
            n_hit += got[0].size
    assert n_hit > 1000


def test_device_containment_regime_bounds(monkeypatch):
    """merge below BUCKET_MIN, bucket from it, grange from GRANGE_MIN."""
    _, tg, _, ts, _ = _engine_world(1)
    total = sum(g.genome_kmers.size for g in tg)
    for bmin, gmin, want in ((total + 1, total + 2, "merge"),
                             (total, total + 1, "bucket"),
                             (0, total, "grange")):
        monkeypatch.setattr(DeviceContainment, "BUCKET_MIN", bmin)
        monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", gmin)
        eng = DeviceContainment(tg, device="cpu")
        got = ("grange" if eng._grange is not None
               else "bucket" if eng._use_buckets else "merge")
        assert got == want
        assert eng.hists(ts).sum() > 0


# ---- CLI TSVs --------------------------------------------------------------

def _run_both(mode, files, argv, opts, monkeypatch, tmp_path):
    """(port TSV, JAX host TSV, the port's engine)."""
    want = io.StringIO()
    contain(ContainOptions(files=files, tpu=False, **opts),
            pseudotax=(mode == "profile"), out=want)
    engines = []
    make = runner._device_engine_for
    monkeypatch.setattr(runner, "_device_engine_for", lambda *a, **kw:
                        engines.append(make(*a, **kw)) or engines[-1])
    out = tmp_path / "out.tsv"
    assert cli.main([mode, *argv, "--device", "cpu", "-o", str(out)]) == 0
    got = out.read_text()
    assert len(got.strip().splitlines()) > 1
    return got, want.getvalue(), engines[0]


@pytest.mark.parametrize("mode", ["profile", "query"])
@pytest.mark.parametrize("sample", ["sylsp", "reads"])
def test_cli_merge_regime_world(world, mode, sample, monkeypatch,
                                tmp_path):
    db = str(world / "db.syldb")
    smp = str(world / ("sample.fq.sylsp" if sample == "sylsp"
                       else "sample.fq"))
    got, want, eng = _run_both(mode, [db, smp], [db, smp, "-c", "25"],
                               dict(c=25), monkeypatch, tmp_path)
    assert got == want
    assert eng._grange is None and not eng._use_buckets


@pytest.mark.parametrize("mode", ["profile", "query"])
@pytest.mark.parametrize("reads", ["single", "paired"])
def test_cli_merge_regime_ecoli_reads(ecoli_db, mode, reads, monkeypatch,
                                      tmp_path):
    if reads == "single":
        o157 = os.path.join(_TF, "o157_reads.fastq.gz")
        files, argv, extra = [ecoli_db, o157], [ecoli_db, o157], {}
    else:
        r1, r2 = (os.path.join(_TF, f"k12_R{i}.fq") for i in (1, 2))
        files, argv = [ecoli_db], [ecoli_db, "-1", r1, "-2", r2]
        extra = dict(first_pair=[r1], second_pair=[r2])
    got, want, eng = _run_both(mode, files, argv + ["-c", "100"],
                               dict(c=100, **extra), monkeypatch, tmp_path)
    assert got == want
    assert eng._grange is None and not eng._use_buckets


@pytest.mark.parametrize("mode", ["profile", "query"])
@pytest.mark.parametrize("sample", ["sylsp", "reads"])
def test_cli_bucket_regime_world(world, mode, sample, monkeypatch,
                                 tmp_path):
    monkeypatch.setattr(DeviceContainment, "BUCKET_MIN", 1000)
    monkeypatch.setattr(DeviceContainment, "CHUNK", 1 << 14)
    db = str(world / "db.syldb")
    smp = str(world / ("sample.fq.sylsp" if sample == "sylsp"
                       else "sample.fq"))
    got, want, eng = _run_both(mode, [db, smp], [db, smp, "-c", "25"],
                               dict(c=25), monkeypatch, tmp_path)
    assert got == want
    assert eng._use_buckets and len(eng._bchunks) > 1
