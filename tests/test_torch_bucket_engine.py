"""The bucket regime's engine (sylph_tpu_torch/gpu/bucket_join.py::
BucketEngine) on the CPU, at small sizes, against the plain reference of
perfbench/reference/ (plain torch, no JAX) and the merge join.

- Whole-database [G, H] histograms of shallow- and deep-like occurrence
  streams over 2-4 chunks, at H = 64 and 256: bins 1..H-1 equal the
  reference join's, every bin (0 included) equals ``genome_hist`` of the
  merge join's counts; the fold clamps at H - 1.
- Statistics from the engine's histograms within the benchmark cell's
  ``stat_gap`` limit of the reference's (float64).
- A sample capacity too small for the sample: a non-zero probe; the call
  again at a larger capacity is exact and counts as a refill.
- ``DeviceContainment``'s bucket-regime counts against a frozen copy of
  the per-chunk loop it ran before the engine, and its prefilter
  histograms, now the engine's, against the host bincount of those
  counts that made them before.
- The engine's spans and counters under a profiler.
Every input is made by numpy from a seed.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.check import stats_mismatch
from perfbench.reference import join as ref_join
from perfbench.reference import stats as ref_stats
from perfbench.reference.sketch import multiset
from perfbench.result import INTS
from sylph_tpu_torch.core.types import GenomeSketch, SequencesSketch
from sylph_tpu_torch.engine.device_exec import DeviceContainment
from sylph_tpu_torch.gpu import bucket_join as bj
from sylph_tpu_torch.gpu.containment import (build_host_index, genome_hist,
                                             merge_join_counts)
from sylph_tpu_torch.gpu.grange import fold_stream
from sylph_tpu_torch.gpu.keys import KEY_PAD
from sylph_tpu_torch.gpu.stats import stats_from_histograms
from sylph_tpu_torch.utils import timing

C, K = 200, 31
THR = ((1 << 64) - 1) // C
STAT_GAP = 1e-4          # perfbench/configs/uhgg_v2_bucket.json's limit
CPU = torch.device("cpu")


class World:
    """G genomes of ``kpg`` distinct keys each, in the CLI's order (genome
    by genome, padded as the bucket regime pads), cut into ``chunk``-slot
    chunks; the reference's view of the same index."""

    def __init__(self, seed: int, G: int, kpg: int, chunk: int):
        rng = np.random.default_rng(seed)
        keys = np.unique(rng.integers(0, THR, size=G * kpg * 2,
                                      dtype=np.uint64))
        keys = rng.permutation(keys)[:G * kpg]
        self.G, self.kpg, self.chunk = G, kpg, chunk
        self.genomes = [keys[g * kpg:(g + 1) * kpg] for g in range(G)]
        total = G * kpg
        self.index = build_host_index(
            self.genomes, pad_multiple=bj.padded_slots(total, chunk))
        self.engine = bj.BucketEngine(self.index, C, chunk=chunk, device=CPU)
        self.keys = torch.from_numpy(self.index.keys[:total])
        self.gids = torch.from_numpy(self.index.genome_ids[:total])
        self.n_kmers = torch.from_numpy(self.index.n_kmers)
        self.rng = rng

    def flat_blocks(self):
        """The reference join's view: (block, keys, genome ids)."""
        yield 0, self.keys, self.gids

    def stream(self, kind: str) -> torch.Tensor:
        """An occurrence stream: three genomes' keys at Poisson
        multiplicities of three means (deep: 20, 80 and 320, past both
        clamps), random keys around them, -1 pads, in random order."""
        rng = self.rng
        lam = {"shallow": 0.3, "deep": 40.0}[kind]
        parts = []
        for g, x in zip(rng.choice(self.G, size=3, replace=False),
                        (0.5, 2.0, 8.0)):
            mult = rng.poisson(lam * x, size=self.kpg)
            parts.append(np.repeat(self.genomes[g], mult))
        parts.append(rng.integers(0, THR, size=3000, dtype=np.uint64))
        occ = np.concatenate(parts).view(np.int64)
        occ = np.concatenate([occ, np.full(500, KEY_PAD, np.int64)])
        return torch.from_numpy(rng.permutation(occ))


_WORLDS = {}


def _world(n_chunks: int) -> World:
    """A world cut into ``n_chunks`` chunks (the last one part padding)."""
    if n_chunks not in _WORLDS:
        chunk = 4096
        kpg = 300
        G = (n_chunks - 1) * chunk // kpg + 2
        w = World(10 + n_chunks, G, kpg, chunk)
        assert len(w.engine.chunks) == n_chunks
        _WORLDS[n_chunks] = w
    return _WORLDS[n_chunks]


def _merge_hist(w: World, stream: torch.Tensor, H: int) -> torch.Tensor:
    """genome_hist of the merge join's per-slot counts of the stream."""
    skey, sw = fold_stream(stream, clamp=255)
    counts = merge_join_counts(torch.from_numpy(w.index.keys), skey,
                               sw.to(torch.int32))
    return genome_hist(torch.from_numpy(w.index.genome_ids), counts, w.G, H)


CASES = [(n, kind, H) for n in (2, 4) for kind in ("shallow", "deep")
         for H in (64, 256)]


@pytest.mark.parametrize("n_chunks,kind,H", CASES)
def test_histograms_equal_the_reference_and_the_merge_join(n_chunks, kind,
                                                           H):
    w = _world(n_chunks)
    stream = w.stream(kind)
    hist, probe = w.engine.hist_device_stream(stream, n_buckets=H)
    assert int(probe) == 0
    assert hist.dtype == torch.int32 and tuple(hist.shape) == (w.G, H)
    ref, n_kmers, _matched = ref_join.histograms(w, [multiset(stream)], H)
    assert torch.equal(hist[:, 1:].to(torch.int64), ref[0][:, 1:])
    assert torch.equal(n_kmers, w.n_kmers.to(torch.int64))
    assert torch.equal(hist, _merge_hist(w, stream, H))
    assert int(hist[:, 1:].sum()) > 0
    if kind == "deep":
        assert int(hist[:, H - 1].sum()) > 0        # the clamp is reached


@pytest.mark.parametrize("H,want_bin", [(256, 100), (64, 63)])
def test_a_kmer_seen_100_times_lands_in_its_clamped_bin(H, want_bin):
    w = _world(2)
    g = w.G - 1                                      # in the last chunk
    key = int(w.genomes[g][7])
    stream = torch.full((100,), key, dtype=torch.int64)
    hist, probe = w.engine.hist_device_stream(stream, n_buckets=H)
    assert int(probe) == 0
    assert int(hist[g, want_bin]) == 1
    assert int(hist[:, 1:].sum()) == 1
    assert int(hist[g, 0]) == w.kpg - 1
    assert torch.equal(hist[:, 0], w.n_kmers - hist[:, 1:].sum(1))


def _host_stats(st) -> dict:
    out = {f: getattr(st, f).to(torch.float64).numpy()
           for f in ref_stats.FLOATS}
    out.update({f: getattr(st, f).to(torch.int64).numpy() for f in INTS})
    return out


@pytest.mark.parametrize("kind", ["shallow", "deep"])
def test_statistics_agree_with_the_reference(kind):
    w = _world(3)
    stream = w.stream(kind)
    hist, _probe = w.engine.hist_device_stream(stream, n_buckets=256)
    st = stats_from_histograms(hist, w.n_kmers, k=K, min_ani=0.95)
    ref, n_kmers, _m = ref_join.histograms(w, [multiset(stream)], 256)
    want = ref_stats.genome_stats(ref, n_kmers, k=K)
    want = {f: v[0].numpy() for f, v in want.items()}
    counted, gap = stats_mismatch(_host_stats(st), want)
    assert counted == 0 and gap < STAT_GAP
    assert (want["contained"] > 0).sum() >= 3


def test_a_small_capacity_fails_the_probe_and_a_larger_one_is_exact():
    w = _world(2)
    stream = w.stream("deep")
    skey, sw = fold_stream(stream, clamp=255)
    t = int(skey.shape[0])
    assert t / w.engine.chunks[0].n_buckets > 16
    want = _merge_hist(w, stream, 256)
    small, probe = w.engine.hist_device_stream(skey, sw, n_buckets=256, cs=8)
    assert int(probe) > 0 and not torch.equal(small, want)
    assert w.engine.counters["refills"] == 0
    big = 2 * w.engine.cs(t)
    hist, probe = w.engine.hist_device_stream(skey, sw, n_buckets=256,
                                              cs=big)
    assert int(probe) == 0 and torch.equal(hist, want)
    assert w.engine.counters["refills"] == 1


def _frozen_counts(eng: DeviceContainment, skey, sw, n: int) -> np.ndarray:
    """The bucket regime's per-chunk loop as it ran before the engine: each
    CHUNK-slot chunk of the host index bucketed (its live prefix), B1 +
    B5' a chunk, the counts written in chunk order."""
    keys, m = eng.index.keys, eng.index.keys.size
    total = int(eng.index.n_kmers.sum())
    c_min = min(g.c for g in eng._genome_sketches)
    out = torch.zeros(m, dtype=torch.int32)
    for s in range(0, m, eng.CHUNK):
        n_live = min(max(total - s, 0), eng.CHUNK)
        ch = bj.build_bucketed_index(keys[s:s + n_live], c_min,
                                     n_slots=min(eng.CHUNK, m - s))
        out[s:s + ch.m] = bj.bucket_join_counts(ch, skey, sw, n)
    return out.numpy()


def _containment(monkeypatch, w: World) -> DeviceContainment:
    """``DeviceContainment`` over the world's genomes, in the bucket regime
    at the world's chunk size."""
    monkeypatch.setattr(DeviceContainment, "BUCKET_MIN", 1000)
    monkeypatch.setattr(DeviceContainment, "CHUNK", w.chunk)
    gs = [GenomeSketch(genome_kmers=k, pseudotax_tracked_nonused_kmers=None,
                       file_name=f"g{g}", first_contig_name=f"c{g}", c=C,
                       k=K, gn_size=1, min_spacing=30)
          for g, k in enumerate(w.genomes)]
    eng = DeviceContainment(gs, device="cpu")
    assert eng._use_buckets and eng._bchunks is eng._bucket.chunks
    return eng


def _sample(w: World, kind: str) -> SequencesSketch:
    if kind == "empty":
        sk, sc = torch.zeros(0, dtype=torch.int64), torch.zeros(0)
    else:
        sk, sc = multiset(w.stream(kind))
    return SequencesSketch(kmers=sk.numpy().view(np.uint64),
                           counts=sc.numpy().astype(np.uint32), c=C, k=K,
                           file_name="s")


@pytest.mark.parametrize("kind", ["shallow", "deep"])
def test_device_containment_counts_unchanged(monkeypatch, kind):
    w = _world(3)
    eng = _containment(monkeypatch, w)
    assert len(eng._bchunks) == 3
    sample = _sample(w, kind)
    got = eng._counts(sample)
    skey, sw = eng.upload_table(sample)
    want = _frozen_counts(eng, skey, sw, int(sample.kmers.size))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert eng._bucket.counters["chunk_joins"] == 3
    assert eng._bucket.counters["stream_hists"] == 0


def _frozen_hists(eng: DeviceContainment, counts: np.ndarray) -> np.ndarray:
    """The prefilter's histograms as the bucket regime made them before the
    engine served them: a host bincount of the exact per-slot counts."""
    gids = eng.index.genome_ids
    G = int(eng.index.n_genomes)
    m = (counts > 0) & (gids < G)
    seg = (gids[m].astype(np.int64) * 64
           + np.minimum(counts[m].astype(np.int64), 63))
    return np.bincount(seg, minlength=G * 64).reshape(G, 64)


@pytest.mark.parametrize("kind,cs", [("shallow", None), ("deep", None),
                                     ("deep", 8), ("empty", None)])
def test_device_containment_hists_come_from_the_engine(monkeypatch, kind,
                                                       cs):
    """The prefilter's [G, 64] histograms in the bucket regime are the
    engine's device histogram, equal to the host bincount of the exact
    counts that served them before; no per-slot counts are made for them.
    With the engine's capacity forced to 8 lanes, the probe fails and the
    call is run again at doubled capacities until it is exact."""
    w = _world(3)
    eng = _containment(monkeypatch, w)
    if cs is not None:
        monkeypatch.setattr(bj.BucketEngine, "cs", lambda self, t: cs)
    sample = _sample(w, kind)
    got = eng.hists(sample)
    ctr = eng._bucket.counters
    calls = ctr["stream_hists"]
    assert eng._cache == {} and ctr["chunk_joins"] == 3 * calls
    assert ctr["refills"] == calls - 1 and (calls > 1) == (cs is not None)
    want = _frozen_hists(eng, eng._counts(sample))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert (want.sum() > 0) == (kind != "empty")


PARENTS = {"bucket": None, "fold": "bucket", "fold.mask": "fold",
           "fold.unique": "fold", "bucket.chunk": "bucket",
           "bucket.fill": "bucket.chunk", "bucket.join": "bucket.chunk",
           "bucket.bin": "bucket.chunk"}


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_spans_and_counters_under_a_profiler(n_chunks):
    w = _world(n_chunks)
    eng = bj.BucketEngine(w.index, C, chunk=w.chunk, device=CPU)
    stream = w.stream("shallow")
    off = eng.hist_device_stream(stream)
    timing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            on = eng.hist_device_stream(stream)
        recs = timing.records()
    finally:
        timing.reset()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    by_id = {r.id: r for r in recs}
    assert {r.name for r in recs} == set(PARENTS)
    for r in recs:
        parent = by_id[r.parent].name if r.parent is not None else None
        assert parent == PARENTS[r.name], r
        assert r.wait == (r.name in ("fold.mask", "fold.unique"))
        assert r.thread == threading.get_ident()
    for part in ("bucket.chunk", "bucket.fill", "bucket.join", "bucket.bin"):
        assert sum(r.name == part for r in recs) == n_chunks
    assert eng.counters == {"stream_hists": 2,
                            "chunk_joins": 2 * n_chunks, "refills": 0}


def test_fold_clamp_is_set_by_the_caller():
    stream = torch.tensor([5] * 300 + [7] * 2 + [-1] * 3)
    for clamp, want in ((63, 63), (255, 255), (1, 1)):
        skey, w = fold_stream(stream, clamp=clamp)
        assert skey.tolist() == [5, 7] and w.dtype == torch.uint8
        assert w.tolist() == [want, min(2, clamp)]
    assert fold_stream(stream)[1].tolist() == [63, 2]
    for bad in (0, 256):
        with pytest.raises(ValueError, match="clamp"):
            fold_stream(stream, clamp=bad)
