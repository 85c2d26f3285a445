"""The port's benchmark: the configs of the JAX package's root bench.py,
run on the card through sylph_tpu_torch.

    python -m sylph_tpu_torch.bench [--config NAME] [--device cuda|cpu]
        [--genomes N] [--samples S] [--match 0|1] [--index device|host]
        [--dup] [--stages]

Configs (default ``gtdb``), each printing one JSON line under the JAX
bench's metric name, after lines giving the card's name and power limit:

  gtdb         gtdb_profile_throughput[_dupskew] (Gbp/s): 64 batches of
               [65,536, 256] planted reads (1.07 Gbp) made on the device,
               seeded (B6), condensed (B8), folded and swept against a
               100,000-genome x 7,168-k-mer index (B1-B4), statistics; the
               index made on the device (gpu/synth_index.py) or, with
               ``--index host``, built on the host from sorted order
               statistics (cached under .bench_data/torch_gtdb_*).
               ``--samples S`` sweeps S samples in groups of
               SYLPH_COHORT_SUB (default 4) through one batched sweep each;
               ``--dup`` the duplication-skewed index, markers expanded on
               the device inside the timed region.
  profile      profile_throughput: 64 copies of one batch against 1,024
               genomes x 4,096 k-mers (the merge join).
  sketch       sketch_throughput: sketch_batch alone.
  multisample  multisample_containment (samples/s): S = 8 through
               finish_profile_batched.
  e2e, e2e_paired  e2e[_paired]_file_to_tsv_throughput: ``profile`` of a
               fastq.gz (or a pair) against 64 genomes, file to TSV
               (fixture: python -m sylph_tpu_torch.bench_fixtures e2e).
  gtdb_cli     gtdb_cli_file_to_tsv_throughput: ``profile`` of a 1.07 Gbp
               planted fastq.gz against the 100,000-genome .syldb from a
               resident index (fixture: ... bench_fixtures gtdb_cli).
  sketchdb     sketch_db_build_throughput: ``sketch -g`` of 107 x 10 Mbp.

Timing ends in torch.cuda.synchronize() or a scalar fetch; medians and rep
counts are the JAX bench's. ``--device cpu`` runs a config on the CPU
(plain kernel versions), at tiny sizes for tests; without it and without a
GPU the bench raises.

Not carried over from the JAX bench: its compilation cache, its relay
probe (``_require_backend``), its transient-backend re-exec and its
recorded-median lines (TPU numbers). Its threefry draws of the reads and
overlay offsets become a ``torch.Generator`` on the device (same shapes and
distributions, other bits); the index, plants and payloads are the JAX
bench's bit for bit.
"""

import argparse
import io
import json
import os
import sys
import time

import numpy as np
import torch

BASELINE_GBPS = 0.33             # reference sylph, README.md:16-28

C, K = 200, 31
READ_LEN = 256                   # B6's 128-column multiple
BATCH_READS = 65536              # ~16.8 Mbp per batch
N_GENOMES = 1024
KMERS_PER_GENOME = 4096          # ~4.2M index k-mers
N_BUCKETS = 256
N_BATCHES = 64                   # ~1.07 Gbp streamed per timed run
N_ABUNDANT = 512                 # deep-coverage genomes of the gtdb plants

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(_ROOT, ".bench_data")
_M32 = 0xFFFFFFFF


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_median(run, reps, label, unit="s", nd=3):
    """Median of ``reps`` runs; prints every rep, the median and the
    min."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"# {label} timed runs: {[round(x, nd) for x in times]} "
          f"(median {med:.{nd}f}{unit}, min {min(times):.{nd}f}{unit})",
          flush=True)
    return med


def _reads_flat(keys: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """A batch's survivor keys read by read: B9's [cap_rows, N] layout
    (SYLPH_SEED_T=1) is transposed first, since flattening it row by row
    drops survivors in the condensation (ROADMAP C)."""
    from .gpu import pipeline as pl
    if pl._seed_route(*bases.shape, C, K) == "B9":
        return keys.t().reshape(-1)
    return keys.reshape(-1)


# ---- profile, sketch, multisample ------------------------------------------

def _profile_inputs(device):
    """The JAX bench's main() data: one [BATCH_READS, READ_LEN] batch and
    N_GENOMES x KMERS_PER_GENOME random sketches, from numpy seed 0."""
    from .gpu.containment import build_host_index
    rng = np.random.default_rng(0)
    bases = rng.integers(0, 4, size=(BATCH_READS, READ_LEN),
                         dtype=np.uint8).astype(np.uint32)
    thr = ((1 << 64) - 1) // C
    genomes = [rng.integers(0, thr, size=KMERS_PER_GENOME, dtype=np.uint64)
               for _ in range(N_GENOMES)]
    idx = build_host_index(genomes)
    dev = torch.device(device)
    return (torch.from_numpy(bases.astype(np.uint8)).to(dev),
            torch.full((BATCH_READS,), READ_LEN, dtype=torch.int32,
                       device=dev),
            tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (idx.keys, idx.genome_ids, idx.n_kmers)))


def _bench_profile(bases, lengths, idx_dev, device, reps=5):
    """profile_throughput: N_BATCHES sketches of the batch, condensed (B8),
    the merge join and the statistics; median of ``reps`` after a warm-up
    run."""
    from .gpu import pipeline as pl
    from .gpu.bucket_fill import condense_stream

    def run_once():
        parts = [_reads_flat(pl.sketch_batch(bases, lengths, c=C, k=K,
                                             device=device)[0], bases)
                 for _ in range(N_BATCHES)]
        keys = torch.cat(parts)
        live = (READ_LEN - K + 1) / C / (keys.numel()
                                         / (N_BATCHES * BATCH_READS))
        keys = condense_stream(keys, live)
        hist, _st = pl.finish_profile(keys, *idx_dev, k=K,
                                      n_genomes=N_GENOMES,
                                      n_buckets=N_BUCKETS, min_ani=0.5,
                                      device=device)
        return float(hist.sum().item())        # the scalar fetch syncs

    run_once()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_once()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    print(f"# timed runs: {[round(x, 3) for x in sorted(times)]} "
          f"(median {dt:.3f}s, spread "
          f"{(max(times) - min(times)) / dt * 100:.0f}%)", flush=True)
    return N_BATCHES * BATCH_READS * READ_LEN / dt / 1e9


def _bench_sketch_only(bases, lengths, device, n_batches=64, warm=4):
    """sketch_throughput: ``n_batches`` sketches of the batch."""
    from .gpu import pipeline as pl
    for _ in range(warm):
        pl.sketch_batch(bases, lengths, c=C, k=K, device=device)
    _sync(device)
    t0 = time.perf_counter()
    outs = [pl.sketch_batch(bases, lengths, c=C, k=K, device=device)[0]
            for _ in range(n_batches)]
    _sync(device)
    dt = time.perf_counter() - t0
    del outs
    return n_batches * bases.shape[0] * READ_LEN / dt / 1e9


def _bench_multisample(bases, lengths, idx_dev, device, S=8):
    """multisample_containment: S samples through finish_profile_batched
    (one merge join a sample against the shared index), samples/s."""
    from .gpu import pipeline as pl
    smp = torch.stack([_reads_flat(pl.sketch_batch(bases, lengths, c=C, k=K,
                                                   device=device)[0], bases)
                       for _ in range(S)])

    def run():
        hist, _st = pl.finish_profile_batched(
            smp, *idx_dev, k=K, n_genomes=N_GENOMES, n_buckets=N_BUCKETS,
            min_ani=0.5, device=device)
        return float(hist.sum().item())

    run()
    t0 = time.perf_counter()
    run()
    return S / (time.perf_counter() - t0)


# ---- the GTDB-scale index and its plants -----------------------------------

def _synth_sorted_index(M, G, c, seed=1):
    """(sorted uniform u64 hashes below 2^64/c, random genome ids): order
    statistics from exponential spacings, O(M) without a global sort."""
    rng = np.random.default_rng(seed)
    thr = float((1 << 64) // c)
    d = rng.exponential(size=M + 1)
    cum = np.cumsum(d)
    kmers = (cum[:-1] * (thr / cum[-1])).astype(np.uint64)
    # a power-of-two draw and a modulo: no rejection sampling (the 2^-16
    # modulo bias does not matter to a throughput benchmark)
    gids = (rng.integers(0, 1 << 31, size=M, dtype=np.int32)
            % np.int32(G)).astype(np.int32)
    return kmers, gids


def load_gtdb_index(G: int, KPG: int, device="cuda", root=None):
    """The host-built synthetic GTDB-class grange index (G genomes x KPG
    k-mers, c = 200), cached under ``root``/torch_gtdb_<G>_<KPG>[_nt<nt>]
    (the JAX bench caches (hi, lo) grids under gtdb_*)."""
    from .gpu.grange import GRangeIndex, build_grange_index
    from .gpu.synth_index import _default_nt

    nt = _default_nt()
    cache = os.path.join(root or DATA, f"torch_gtdb_{G}_{KPG}"
                         + (f"_nt{nt}" if nt > 1 else ""))
    meta_p = os.path.join(cache, "meta.npz")
    if os.path.exists(meta_p):
        meta = np.load(meta_p)
        n = int(meta["n_chunks"])
        return GRangeIndex(
            [torch.from_numpy(np.load(os.path.join(cache, f"keys{i}.npy")))
             for i in range(n)],
            [torch.from_numpy(np.load(os.path.join(cache, f"gid{i}.npy")))
             for i in range(n)],
            meta["bases"], meta["edges"], int(meta["width"]),
            int(meta["B"]), int(meta["CI"]), meta["spill_kmers"],
            meta["spill_gids"], int(meta["m"]), G, nt=int(meta["nt"]),
            ov=int(meta["ov"]))
    kmers, gids = _synth_sorted_index(G * KPG, G, C, seed=1)
    gidx = build_grange_index(kmers, gids, G, target_mean=1024,
                              device=device)
    del kmers, gids
    os.makedirs(cache, exist_ok=True)
    for i, (k, g) in enumerate(zip(gidx.chunk_keys, gidx.chunk_gid)):
        np.save(os.path.join(cache, f"keys{i}.npy"), k.numpy())
        np.save(os.path.join(cache, f"gid{i}.npy"), g.numpy())
    np.savez(meta_p, n_chunks=len(gidx.chunk_keys), bases=gidx.bases,
             edges=gidx.edges_u64, width=gidx.width, B=gidx.B, CI=gidx.CI,
             spill_kmers=gidx.spill_kmers, spill_gids=gidx.spill_gids,
             m=gidx.m, nt=gidx.nt, ov=gidx.ov)
    return gidx


def _rc31_np(v: np.ndarray) -> np.ndarray:
    """Reverse complements of 31-mers packed 2-bit MSB-first in uint64:
    complement the low 62 bits, reverse the 2-bit groups, shift down."""
    u = np.uint64
    x = ~v & u((1 << 62) - 1)
    m2, m4 = u(0x3333333333333333), u(0x0F0F0F0F0F0F0F0F)
    x = ((x >> u(2)) & m2) | ((x & m2) << u(2))
    x = ((x >> u(4)) & m4) | ((x & m4) << u(4))
    return x.byteswap() >> u(2)


def _usable_plants(gidx, per_chunk: int, gid_max=None):
    """(kmer u64, gid) index entries whose hash inverts to a canonical
    31-mer (about 1/8 of slots), strided over ``per_chunk`` live slots a
    chunk; ``gid_max`` keeps the first genomes only (the abundant pool)."""
    from .kmer.hashing import inv_mm_hash64_np
    ks, gs = [], []
    for keys, gid in zip(gidx.chunk_keys, gidx.chunk_gid):
        h = keys.reshape(-1).cpu().numpy().view(np.uint64)
        g = gid.reshape(-1).cpu().numpy()
        m = (h >> np.uint64(32)) != np.uint64(_M32)
        if gid_max is not None:
            m &= g < gid_max
        idx = np.flatnonzero(m)
        if idx.size > per_chunk:
            idx = idx[::idx.size // per_chunk][:per_chunk]
        ks.append(h[idx])
        gs.append(g[idx])
    k = np.concatenate(ks)
    g = np.concatenate(gs)
    v = inv_mm_hash64_np(k)
    ok = (v < np.uint64(1) << np.uint64(62)) & (v <= _rc31_np(v))
    return k[ok], g[ok]


def _plant_pool(gidx, total, n_abundant=N_ABUNDANT, abundant_mult=3,
                synth=None, dup=None, device="cuda"):
    """[total] index hashes to plant (unshuffled) and the abundant pool's
    size: the ``n_abundant`` first genomes' usable k-mers ``abundant_mult``
    times each, then singleton background plants over all genomes.
    ``synth`` = (G, KPG) regenerates them from the synthetic index's
    counters on ``device`` rather than reading the chunks."""
    if synth is not None:
        from .gpu.synth_index import synth_plants_host
        sg, skpg = synth
        ab_k, _ = synth_plants_host(sg, skpg, C, per_chunk=1 << 22,
                                    gid_max=n_abundant, dup=dup,
                                    device=device)
        bg_k, _ = synth_plants_host(sg, skpg, C, per_chunk=max(
            1024, int((total - ab_k.size * abundant_mult) * 1.3 * 8
                      // len(gidx.chunk_keys))), dup=dup, device=device)
        ab = np.repeat(ab_k, abundant_mult)
    else:
        ab_k, _ = _usable_plants(gidx, per_chunk=1 << 22,
                                 gid_max=n_abundant)
        ab = np.repeat(ab_k, abundant_mult)
        bg_k, _ = _usable_plants(gidx, per_chunk=max(
            1024, int((total - ab.size) * 1.3 * 8 // len(gidx.chunk_keys))))
    # the extractors emit plants in (chunk, bucket) order: cutting a pool
    # unshuffled would put every match in the first chunks, so shuffle
    # before any cut
    rng = np.random.default_rng(11)
    n_bg = max(0, total - ab.size)
    if bg_k.size < n_bg:        # repeat the background if the pool is short
        bg = np.tile(bg_k, -(-n_bg // max(1, bg_k.size)))[:n_bg]
    else:
        rng.shuffle(bg_k)
        bg = bg_k[:n_bg]
    if ab.size > total:
        rng.shuffle(ab)
    plants = np.concatenate([ab, bg])[:total]
    return plants, int(ab_k.size)


def _plant_payload(plants, n_batches, R, seed, device):
    """Shuffle a plant list and invert each hash to its canonical 31-mer:
    [n_batches, R] int64 on ``device`` (8 bytes a read)."""
    from .kmer.hashing import inv_mm_hash64_np
    p = plants.copy()
    np.random.default_rng(seed).shuffle(p)
    vmer = inv_mm_hash64_np(p).view(np.int64).reshape(n_batches, R)
    return torch.from_numpy(np.ascontiguousarray(vmer)).to(device)


def _make_overlay(R, L):
    """overlay(b8 [R, L] uint8, vmer [R] int64, generator) -> b8 with each
    row's 31-mer written at an offset drawn from the generator."""
    def overlay(b8, vmer, gen):
        off = torch.randint(0, L - 31 + 1, (R, 1), generator=gen,
                            device=b8.device)
        j = torch.arange(L, device=b8.device)[None, :] - off
        in_plant = (j >= 0) & (j < 31)
        sh = torch.clamp(2 * (30 - j), 0, 62)
        val = ((vmer[:, None] >> sh) & 3).to(torch.uint8)
        return torch.where(in_plant, val, b8)
    return overlay


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _plant_reads(bases8, gidx, seed=7, n_abundant=N_ABUNDANT,
                 abundant_mult=3, synth=None, dup=None, device="cuda"):
    """Overlay one index 31-mer on every read (on the device): every read
    carries a k-mer whose sketch hash is in the database, as a sample of
    database genomes does. Returns (planted reads, abundant pool size,
    distinct plants)."""
    n_batches, R, L = bases8.shape
    plants, n_ab = _plant_pool(gidx, n_batches * R, n_abundant,
                               abundant_mult, synth=synth, dup=dup,
                               device=device)
    vmer = _plant_payload(plants, n_batches, R, seed, bases8.device)
    overlay = _make_overlay(R, L)
    gen = _generator(bases8.device, seed)
    planted = torch.empty_like(bases8)
    for i in range(n_batches):
        planted[i] = overlay(bases8[i], vmer[i], gen)
    return planted, n_ab, int(np.unique(plants).size)


# ---- gtdb -------------------------------------------------------------------

def _bench_gtdb(n_genomes=100_000, kmers_per_genome=7168,
                n_batches=None, n_samples=1, match=True,
                index_mode="device", dup=None, device="cuda", reps=7,
                batched_reps=5, stages=False):
    """Database-scale config: planted reads profiled against a GTDB-class
    grange index resident on the device, end to end on the device (seed,
    condense, fold, chunked join, histograms, statistics), one fetch a run.

    Returns (Gbp/s, info): info holds the stage seconds ("synth_s",
    "plants_s", "upload_s", "warmup_s", "median_s"), the index and engine,
    ``seed_all(s)`` (sample s's condensed occurrence stream), ``run_once``
    (one single-sample run: (contained sum, exact)) and the last
    timed run's histograms ("hist", g_eff*64+1 bins, and with ``dup``
    "expanded", G*64; with ``n_samples`` > 1 "hists", one [S', g_eff*64]
    tensor a group)."""
    from .gpu import pipeline as pl
    from .gpu.bucket_fill import condense_stream
    from .gpu.bucket_join import cell_cs, sample_cs
    from .gpu.grange import GRangeEngine, fold_stream, resolve_device
    from .gpu.keys import KEY_PAD
    from .gpu.stats import stats_from_histograms
    from .gpu.synth_index import (expand_markers_device,
                                  expand_markers_device_batched,
                                  measure_marker_hits, synth_index_device)

    dev = resolve_device(device)
    n_batches = N_BATCHES if n_batches is None else n_batches
    G, KPG = n_genomes, kmers_per_genome
    info = {}
    t0 = time.perf_counter()
    synth = None
    if index_mode == "device":
        gidx = synth_index_device(G, KPG, C, device=dev, dup=dup)
        synth = (G, KPG)
    else:
        if dup is not None:
            raise ValueError("--dup needs the device-made index")
        gidx = load_gtdb_index(G, KPG, device=dev)
    _sync(dev)
    info["synth_s"] = time.perf_counter() - t0
    print(f"# index build/load [{index_mode}]: {info['synth_s']:.1f}s "
          f"({len(gidx.chunk_keys)} chunks of [{gidx.B}, {gidx.CI}], "
          f"{gidx.spill_kmers.size} spilled"
          + (f", {gidx.n_heavy} heavy runs q={dup.q} "
             f"csr={int(gidx.heavy_ptr[-1])}" if dup is not None else "")
          + ")", flush=True)

    t0 = time.perf_counter()
    eng = GRangeEngine(gidx, device=dev)
    n_kmers_dev = torch.full((G,), KPG, dtype=torch.int32, device=dev)
    # n_batches distinct batches made on the device: identical batches
    # would let the fold collapse the sample side n_batches-fold
    bases8 = torch.randint(0, 4, (n_batches, BATCH_READS, READ_LEN),
                           dtype=torch.uint8, device=dev,
                           generator=_generator(dev, 0))
    lengths = torch.full((BATCH_READS,), READ_LEN, dtype=torch.int32,
                         device=dev)
    _sync(dev)
    info["upload_s"] = time.perf_counter() - t0
    print(f"# upload: {info['upload_s']:.1f}s", flush=True)

    t0 = time.perf_counter()
    payloads = overlay = None
    if match:
        if n_samples > 1:
            # a payload permutation a sample, planted inside the seed loop
            pool, n_ab = _plant_pool(gidx, n_batches * BATCH_READS,
                                     synth=synth, dup=dup, device=dev)
            payloads = [_plant_payload(pool, n_batches, BATCH_READS,
                                       1000 + s, dev)
                        for s in range(n_samples)]
            overlay = _make_overlay(BATCH_READS, READ_LEN)
            n_up = int(np.unique(pool).size)
        else:
            bases8, n_ab, n_up = _plant_reads(bases8, gidx, synth=synth,
                                              dup=dup, device=dev)
        _sync(dev)
        print(f"# planted index 31-mers: {n_up} unique ({n_ab} "
              f"deep-coverage over {N_ABUNDANT} genomes)", flush=True)
    info["plants_s"] = time.perf_counter() - t0
    print(f"# plants: {info['plants_s']:.1f}s", flush=True)

    live_frac = [1.0]

    def seed_raw(rot=0):
        parts = []
        for i in range(n_batches):
            b8 = bases8[i]
            if rot:
                b8 = (b8 + rot) & 3
            if payloads is not None:
                b8 = overlay(b8, payloads[rot][i],
                             _generator(dev, rot * 4096 + i))
            keys, _n = pl.sketch_batch(b8, lengths, c=C, k=K, device=dev)
            parts.append(_reads_flat(keys, b8))
        return torch.cat(parts)

    def seed_all(rot=0):
        return condense_stream(seed_raw(rot), live_frac[0])

    # a measured live share sizes the condensation (plants about double
    # the expectation, and a capacity below it would drop survivors)
    raw = seed_raw()
    live_frac[0] = float((raw != KEY_PAD).to(torch.float32).mean().item())
    del raw
    print(f"# live fraction (measured): {live_frac[0]:.5f}", flush=True)
    stream = seed_all()
    n_live = int((stream != KEY_PAD).sum().item())
    n_unique = int(fold_stream(stream)[0].numel())
    # the measured match count sizes the code compaction (every timed run
    # is still checked by its probe)
    h0, _probe, _P = eng.hist_device_stream(stream)
    n_matches = int(h0[:-1].sum().item())
    exp_caps = None
    if dup is not None:
        nr, ne = measure_marker_hits(h0, G=G, n_heavy=gidx.n_heavy,
                                     lbase=dup.lbase, lmod=dup.lmod)
        nr, ne = int(nr.item()), int(ne.item())
        rc = 1 << int(np.ceil(np.log2(max(nr * 1.3 + 64, 128))))
        ec = 1 << int(np.ceil(np.log2(max(ne * 1.3 + 1024, 4096))))
        exp_caps = (min(rc, gidx.n_heavy), ec)
        print(f"# marker hits (measured): {nr} runs, {ne} CSR entries -> "
              f"caps {exp_caps}", flush=True)
    del h0
    info.update(index=gidx, engine=eng, seed_all=seed_all, stream=stream,
                n_live=n_live, n_unique=n_unique, n_matches=n_matches)

    # the engine sizes the cell capacity; a conservation miss in the
    # warm-up raises it by 8 and warms again
    cs_arg = {"cs": None}

    def _auto_cs():
        n_chunks = len(gidx.chunk_keys)
        if gidx.nt > 1:
            return cell_cs(max(1, n_unique // n_chunks), gidx.B * gidx.nt)
        return sample_cs(max(1, n_unique // n_chunks), gidx.B,
                         granularity=8)

    def _expand(hist, batched=False):
        if dup is None:
            return hist, None
        fn = expand_markers_device_batched if batched else \
            expand_markers_device
        return fn(hist, G=G, n_heavy=gidx.n_heavy, runs_cap=exp_caps[0],
                  entries_cap=exp_caps[1], lbase=dup.lbase, lmod=dup.lmod)

    def _fetch(contained, probe, okx):
        """The one fetch of a run: contained sum, probe, expansion flag."""
        parts = [contained.sum().reshape(1).to(torch.float64),
                 probe.to(torch.float64)]
        if okx is not None:
            parts.append(okx.to(torch.float64).reshape(1))
        return torch.cat(parts).cpu().numpy()

    def run_dispatch():
        """One run queued on the device: seed, condense, sweep, expand,
        statistics; nothing fetched."""
        s = seed_all()
        hist, probe, P = eng.hist_device_stream(s, n_matches=n_matches,
                                                cs=cs_arg["cs"])
        hx, okx = _expand(hist)
        st = stats_from_histograms(hx[:G * 64].reshape(G, 64), n_kmers_dev,
                                   k=K, min_ani=0.5)
        info["hist"] = hist
        if okx is not None:
            info["expanded"] = hx
        return st.contained, probe, okx, P

    def run_fetch(state):
        contained, probe, okx, P = state
        v = _fetch(contained, probe, okx)
        ok = v[1] == 0 and v[2] <= P
        if okx is not None:
            ok = ok and bool(v[3])
        return float(v[0]), bool(ok)

    def run_once():
        return run_fetch(run_dispatch())

    info["run_once"] = run_once

    if n_samples > 1:
        S = n_samples
        sub = int(os.environ.get("SYLPH_COHORT_SUB", "4"))

        def run_once_batched():
            tot, ok, hists = 0.0, True, []
            for g0 in range(0, S, sub):
                gs = list(range(g0, min(g0 + sub, S)))
                folds = [fold_stream(seed_all(s)) for s in gs]
                n_each = [int(k.numel()) for k, _w in folds]
                T = max(1024, 1 << int(np.ceil(np.log2(max(max(n_each),
                                                           1)))))
                keys = torch.full((len(gs), T), KEY_PAD, dtype=torch.int64,
                                  device=dev)
                w = torch.zeros((len(gs), T), dtype=torch.uint8, device=dev)
                for r, (k, ww) in enumerate(folds):
                    keys[r, :k.numel()] = k
                    w[r, :k.numel()] = ww
                del folds
                hist, probe, P = eng.hist_device_stream_batched(
                    keys, w, n_each, cs=cs_arg["cs"])
                del keys, w
                hx, okx = _expand(hist, batched=True)
                st = stats_from_histograms(
                    hx[:, :G * 64].reshape(len(gs) * G, 64),
                    n_kmers_dev.repeat(len(gs)), k=K, min_ani=0.5)
                v = _fetch(st.contained, probe, okx)
                tot += float(v[0])
                ok = ok and v[1] == 0 and v[2] <= P
                if okx is not None:
                    ok = ok and bool(v[3])
                hists.append(hist)
            info["hists"] = hists
            return tot, bool(ok)

        t0 = time.perf_counter()
        _, ok = run_once_batched()
        info["warmup_s"] = time.perf_counter() - t0
        print(f"# batched warmup ({S} samples): {info['warmup_s']:.1f}s "
              f"exact={ok}", flush=True)
        for _bump in range(2):
            if ok:
                break
            cs_arg["cs"] = (cs_arg["cs"] or _auto_cs()) + 8
            print(f"# conservation miss: retrying with CS={cs_arg['cs']}",
                  flush=True)
            _, ok = run_once_batched()

        def timed_b():
            _, ok2 = run_once_batched()
            if not ok2:
                raise RuntimeError("grange conservation check failed")

        med = _timed_median(timed_b, batched_reps,
                            f"batched ({S} samples/run)")
        info["median_s"] = med
        return S * n_batches * BATCH_READS * READ_LEN / med / 1e9, info

    print(f"# n_live={n_live} n_unique={n_unique} n_matches={n_matches} "
          "warmup begin", flush=True)
    t0 = time.perf_counter()
    _, ok = run_once()
    info["warmup_s"] = time.perf_counter() - t0
    print(f"# warmup: {info['warmup_s']:.1f}s exact={ok}", flush=True)
    for _bump in range(2):
        if ok:
            break
        cs_arg["cs"] = (cs_arg["cs"] or _auto_cs()) + 8
        print(f"# conservation miss: retrying with CS={cs_arg['cs']}",
              flush=True)
        _, ok = run_once()

    if stages:
        # a synchronized stage split (qualitative: each stage ends in a
        # sync the timed runs do not have)
        for name, sweep in (("seed+cond", False), ("fold+join+hist", True)):
            t0 = time.perf_counter()
            s = seed_all()
            if sweep:
                eng.hist_device_stream(s)
            _sync(dev)
            print(f"# stage through {name}: {time.perf_counter() - t0:.3f}s",
                  flush=True)

    def timed():
        _, ok2 = run_once()
        if not ok2:
            raise RuntimeError("grange conservation check failed")

    timed()                     # a second untimed warm run
    if os.environ.get("SYLPH_BENCH_AB"):
        _timed_median(timed, reps, "gtdb serial (A/B)")
    if os.environ.get("SYLPH_BENCH_PIPELINE", "0") != "0":
        # run i+1 queued before run i's fetch: per-iteration time is
        # dispatch(i+1) + fetch(i); every run's probe is still checked
        times = []
        st = run_dispatch()
        for _i in range(reps):
            t0 = time.perf_counter()
            nxt = run_dispatch()
            _, ok2 = run_fetch(st)
            if not ok2:
                raise RuntimeError("grange conservation check failed")
            st = nxt
            times.append(time.perf_counter() - t0)
        _, ok2 = run_fetch(st)
        if not ok2:
            raise RuntimeError("grange conservation check failed")
        med = float(np.median(times))
        print(f"# gtdb pipelined timed runs: {[round(x, 3) for x in times]}"
              f" (median {med:.3f}s, min {min(times):.3f}s)", flush=True)
    else:
        med = _timed_median(timed, reps, "gtdb")
    info["median_s"] = med
    return n_batches * BATCH_READS * READ_LEN / med / 1e9, info


# ---- file to TSV, and the database build ------------------------------------

def _bench_e2e(paired=False, device="cuda", root=None):
    """gzip fastq file(s) -> profile TSV through the engine (parse, seed,
    dedup, containment, statistics, formatting): 1.07 Gbp against the
    64-genome fixture database (python -m sylph_tpu_torch.bench_fixtures
    e2e [--paired])."""
    from .engine.runner import ContainOptions, contain
    from .io.fastx import stream_blocks

    d = os.path.join(root or DATA, "e2e")
    db = os.path.join(d, "db.syldb")
    reads = os.path.join(d, "reads.fastq.gz")
    r1 = os.path.join(d, "reads_R1.fastq.gz")
    r2 = os.path.join(d, "reads_R2.fastq.gz")
    need = [db, r1, r2] if paired else [db, reads]
    if not all(os.path.exists(p) for p in need):
        raise SystemExit("run python -m sylph_tpu_torch.bench_fixtures e2e"
                         + (" --paired" if paired else "") + " first")
    total_bp = (2 * (1_073_741_824 // 300) * 150 if paired
                else 1_073_741_700)

    def run():
        out = io.StringIO()
        t0 = time.perf_counter()
        if paired:
            contain(ContainOptions(files=[db], first_pair=[r1],
                                   second_pair=[r2], threads=4,
                                   device=device), pseudotax=True, out=out)
        else:
            contain(ContainOptions(files=[db, reads], threads=4,
                                   device=device), pseudotax=True, out=out)
        dt = time.perf_counter() - t0
        tsv = out.getvalue()
        if len(tsv.strip().splitlines()) < 4:     # header + hits
            raise RuntimeError(f"e2e profile found too few genomes:\n{tsv}")
        return dt

    warm = run()
    print(f"# e2e warm-up run: {warm:.1f}s", flush=True)
    times = [run() for _ in range(5)]
    med = float(np.median(times))
    # the host I/O floor: a decode-only pass, after the timed runs
    t0 = time.perf_counter()
    nbytes = sum(len(b) for b in stream_blocks(r1 if paired else reads))
    t_io = time.perf_counter() - t0
    print(f"# e2e timed runs: {[round(x, 1) for x in times]} "
          f"(median {med:.1f}s, min {min(times):.1f}s; decode-only floor "
          f"{t_io:.1f}s, {nbytes / t_io / 1e6:.0f} MB/s text)", flush=True)
    return total_bp / med / 1e9


def _bench_gtdb_cli(device="cuda", db=None, reads=None, cache_dir=None,
                    reps=5, warm=2, stages=False, total_bp=None):
    """``profile db.syldb reads.fastq.gz`` at GTDB scale from a resident
    index: gzip decode, parse, sketch, dedup, grange containment,
    statistics, TSV. The first warm-up run pays the one-time load, layout
    (or its SYLPH_GRANGE_CACHE load, ``cache_dir``) and upload. Defaults:
    the fixture of python -m sylph_tpu_torch.bench_fixtures gtdb_cli."""
    from .engine import runner
    from .engine.runner import ContainOptions, contain

    d = os.path.join(DATA, "gtdb_cli")
    db = db or os.path.join(d, "db.syldb")
    reads = reads or os.path.join(d, "reads.fastq.gz")
    if not (os.path.exists(db) and os.path.exists(reads)):
        raise SystemExit("run python -m sylph_tpu_torch.bench_fixtures "
                         "gtdb_cli first")
    if total_bp is None:
        total_bp = (1_073_741_824 // 150) * 150
    saved = {v: os.environ.get(v) for v in ("SYLPH_TPU_CACHE_INDEX",
                                            "SYLPH_GRANGE_CACHE")}
    os.environ["SYLPH_TPU_CACHE_INDEX"] = "1"
    os.environ["SYLPH_GRANGE_CACHE"] = cache_dir or saved[
        "SYLPH_GRANGE_CACHE"] or d

    def run():
        out = io.StringIO()
        t0 = time.perf_counter()
        contain(ContainOptions(files=[db, reads], threads=4, device=device),
                pseudotax=True, out=out)
        dt = time.perf_counter() - t0
        rows = out.getvalue().strip().splitlines()
        if len(rows) < 33:
            raise RuntimeError("expected about 64 abundant genomes:\n"
                               + "\n".join(rows[:5]))
        return dt

    try:
        w = [run() for _ in range(warm)]
        print(f"# gtdb_cli warm-up runs (the first with the db load): "
              f"{[round(x, 1) for x in w]}", flush=True)
        times = [run() for _ in range(reps)]
        med = float(np.median(times))
        print(f"# gtdb_cli timed runs: {[round(x, 1) for x in times]} "
              f"(median {med:.1f}s, min {min(times):.1f}s)", flush=True)
        if stages:
            import logging
            lg = logging.getLogger("sylph")
            old = lg.level
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter("%(message)s"))
            lg.addHandler(h)
            lg.setLevel(logging.DEBUG)
            try:
                print(f"# gtdb_cli stage-logged run: {run():.1f}s",
                      flush=True)
            finally:
                lg.setLevel(old)
                lg.removeHandler(h)
    finally:
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
        runner._SKETCH_CACHE.clear()
        runner._ENGINE_CACHE.clear()
    return total_bp / med / 1e9


def fasta_bases(paths) -> int:
    """Sequence bytes of fasta files (all but header lines and newlines)."""
    import re
    n = 0
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        n += (len(data) - data.count(b"\n")
              - sum(len(h) for h in re.findall(rb">[^\n]*", data)))
    return n


def _bench_sketchdb(device="cuda", gdir=None, reps=3, paths=None):
    """``sketch -g`` of genome fasta files -> .syldb, timed end to end
    (parse, seeding on ``device``, duplicate drop, spacing, write): by
    default 107 x 10 Mbp synthetic genomes under .bench_data/sketchdb, or
    the given ``paths``."""
    from .engine.sketch_cmd import SketchOptions, sketch

    gdir = gdir or os.path.join(DATA, "sketchdb")
    os.makedirs(gdir, exist_ok=True)
    if paths is None:
        NG, GLEN = 107, 10_000_000
        acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
        rng = np.random.default_rng(3)
        paths = []
        t0 = time.perf_counter()
        for g in range(NG):
            p = os.path.join(gdir, f"g{g:03d}.fa")
            paths.append(p)
            if not os.path.exists(p) or os.path.getsize(p) < GLEN:
                with open(p, "wb") as f:
                    f.write(b">g%03d\n" % g)
                    f.write(acgt[rng.integers(0, 4, GLEN,
                                              dtype=np.uint8)].tobytes())
                    f.write(b"\n")
        total = NG * GLEN
        print(f"# genome fixture: {time.perf_counter() - t0:.0f}s "
              f"({total / 1e9:.2f} Gbp)", flush=True)
    else:
        total = fasta_bases(paths)
    times = []
    out = os.path.join(gdir, "bench_db")
    for rep in range(reps):
        if os.path.exists(out + ".syldb"):
            os.unlink(out + ".syldb")
        t0 = time.perf_counter()
        sketch(SketchOptions(files=[], genomes=list(paths), db_out_name=out,
                             threads=4, device=device))
        times.append(time.perf_counter() - t0)
        print(f"# sketch run {rep}: {times[-1]:.1f}s", flush=True)
    return total / float(np.median(times)) / 1e9


# ---- entry ------------------------------------------------------------------

CONFIGS = ("gtdb", "profile", "sketch", "multisample", "e2e", "e2e_paired",
           "gtdb_cli", "sketchdb")


def result_line(metric: str, value: float, unit: str = "Gbp/s",
                baseline: bool = True) -> str:
    return json.dumps({"metric": metric, "value": round(value, 4),
                       "unit": unit,
                       "vs_baseline": (round(value / BASELINE_GBPS, 2)
                                       if baseline else None)})


def run_config(config: str, device="cuda", genomes: int = 100_000,
               samples: int = 1, match: bool = True, index: str = "device",
               dup: bool = False, stages: bool = False) -> str:
    """Run one config on ``device``; returns its JSON line."""
    from .gpu.grange import resolve_device
    dev = resolve_device(device)
    if config == "gtdb":
        spec = None
        if dup:
            from .gpu.synth_index import DupSpec
            spec = DupSpec()
        gbps, _info = _bench_gtdb(n_genomes=genomes, n_samples=samples,
                                  match=match, index_mode=index, dup=spec,
                                  device=dev, stages=stages)
        return result_line("gtdb_profile_throughput"
                           + ("_dupskew" if dup else ""), gbps)
    if config == "gtdb_cli":
        return result_line("gtdb_cli_file_to_tsv_throughput",
                           _bench_gtdb_cli(dev, stages=stages))
    if config in ("e2e", "e2e_paired"):
        return result_line(f"{config}_file_to_tsv_throughput",
                           _bench_e2e(config == "e2e_paired", dev))
    if config == "sketchdb":
        return result_line("sketch_db_build_throughput",
                           _bench_sketchdb(dev), baseline=False)
    bases, lengths, idx_dev = _profile_inputs(dev)
    if config == "sketch":
        return result_line("sketch_throughput",
                           _bench_sketch_only(bases, lengths, dev))
    if config == "multisample":
        sps = _bench_multisample(bases, lengths, idx_dev, dev)
        return json.dumps({"metric": "multisample_containment",
                           "value": round(sps, 3), "unit": "samples/s",
                           "vs_baseline": None})
    if config == "profile":
        return result_line("profile_throughput",
                           _bench_profile(bases, lengths, idx_dev, dev))
    raise ValueError(f"unknown config {config!r}")


def main(argv=None) -> int:
    if argv is None:
        from .cli import _tune_allocator
        _tune_allocator("sylph_tpu_torch.bench")
        # the bench pins the tiled layout (SYLPH_NT=1 restores the flat)
        os.environ.setdefault("SYLPH_NT", "4")
    ap = argparse.ArgumentParser(
        prog="python -m sylph_tpu_torch.bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="gtdb", choices=CONFIGS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--genomes", type=int, default=100_000)
    ap.add_argument("--samples", type=int, default=1)
    ap.add_argument("--match", default="1")
    ap.add_argument("--index", default="device", choices=("device", "host"))
    ap.add_argument("--dup", action="store_true")
    ap.add_argument("--stages", action="store_true")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    from .gpu.grange import resolve_device
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        from .gpu._cuda import card_line
        print(card_line(), flush=True)
        print(f"# device: {torch.cuda.get_device_name(dev)}", flush=True)
    else:
        print("# device: cpu (plain kernel versions)", flush=True)
    print(run_config(a.config, dev, genomes=a.genomes, samples=a.samples,
                     match=a.match != "0", index=a.index, dup=a.dup,
                     stages=a.stages), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
