#!/usr/bin/env python3
"""On-card smoke test of sylph_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels itself (nvcc, sm_90a, into build/kernels)
and drives the port's main path once, at database scale:

  1. Card and build: the card's name and power limit, then every source of
     sylph_tpu_torch/csrc built, one nvcc each, all started together.
  2. Data from --seed: a database of 100,000 genomes x 7,168 k-mers at
     c=200, k=31 (7.17e8 index k-mers, the grange regime); ``sample.sylsp``,
     the sketch of a ~1.07 Gbp read set (5.3M distinct k-mers: the full
     sketches of 512 genomes at mean multiplicities 1-6, the rest hashes
     absent from the database); ``deep.sylsp``, a deeper, more diverse
     sample (32M distinct k-mers, 512 other genomes planted), whose slices
     are dense enough that the engine emits full code grids (B4); and
     ``reads.fastq.gz``, 2^30 bases of 150-bp reads (bgzf, level 1: the
     shape of a typical Illumina metagenome), each carrying one 31-mer whose
     canonical hash is a database k-mer: the usable k-mers of 64 further
     genomes (20% of them twice), the rest singletons spread over all
     genomes. ``reads_host.sylsp`` is that file sketched with the host C
     seeder, the oracle of the card's sketch.
  3. The main path through the normal entry, ``python -m sylph_tpu_torch
     profile db.syldb reads.fastq.gz sample.sylsp deep.sylsp
     reads_host.sylsp`` (in-process, through cli.main), through the cohort
     loop at its grange depth of 1 (each sample loads while the one before
     it is processed): the raw reads are seeded on the card (B7, B8) while
     their k-mers stream to it, then every sample is swept (B1-B4).
     Checks: (a) each sample's full [G, 64] histogram equals an exact
     searchsorted oracle; (b) the device candidate
     mask contains every genome the host f64 mask keeps; (c) the TSV lists
     exactly the planted genomes of sample and deep; (d) the card's sketch
     of reads.fastq.gz equals the host seeder's; (e) that sample went
     through the streamed device view and the one-fetch stream sweep
     returned its mask; (f) its histogram through the device view equals
     the oracle; (g) its TSV rows equal reads_host.sylsp's, are non-empty
     and list only the 64 abundant genomes; (h) B1-B4, B7 and B8 launched
     on this run (B5 runs only when a chunk fails its conservation check).
     (n) The cohort call ``profile db.syldb sample.sylsp deep.sylsp
     reads_host.sylsp`` at ``SYLPH_COHORT_DEPTH=3``: one batched sweep of
     the three samples, B2b launched once per chunk, no per-sample sweep;
     each batched histogram equals the oracle and each sample's TSV rows
     equal its rows of the main call. The call reuses the main call's
     device engine through the ``runner._device_engine_for`` hook, a
     shortcut of this script (the CLI builds its engine per call), so the
     grange index is not built twice.
  4. The small-database paths, each through the normal entry with the
     launch counts set to 0 just before it: (i) ``sketch -g`` of 256
     generated assemblies of 2-6 Mbp (1 to 200 contigs, repeated 1-3 kb
     segments, N runs; about 1 Gbp) seeded on the card (B7), its .syldb
     byte-identical to the native host seeder's, and ``sketch -i`` on 8
     multi-contig genomes too; (j) ``profile small.syldb small.sylsp``
     (about 5M index k-mers: the merge regime; 32 genomes planted at mean
     multiplicities 1-6 plus 2M absent hashes): [G, 64] histograms equal
     the oracle and the TSV lists exactly the planted genomes; (k)
     ``query`` of 16 of the fasta files plus small.sylsp gives, for them,
     the .syldb query's rows; (l) ``profile bucket.syldb bsample.sylsp``,
     a generated 2,048 x 16,000-k-mer database (32,768,000 index k-mers:
     the bucket regime, 8 chunks, the last partial) and a 5.3M-k-mer
     sample with 128 planted genomes: histograms equal the oracle, the TSV
     lists the planted genomes, every chunk's CI is at most 256; (m) B1
     and B5' launch once per chunk, and B7 launched in (i); (o) ``profile
     small.syldb`` of small.sylsp and three more planted samples at the
     default merge depth (8): one batched merge join whose counts equal
     the per-sample joins', each sample's TSV listing exactly its planted
     genomes.
  5. Every kernel against its plain PyTorch version on the card, at the
     main paths' shapes (chunk 0 of the GTDB-scale index and its real
     sample slices; a [65,536, 256] batch of the real reads; chunk 0 of
     the bucket regime with bsample's whole table; a [2048, 4096] batch of
     genome rows; (p) chunk 0 against the three cohort samples' slices, S =
     3, for B2b, B4b and B5b, and each at S = 1 against B2, B4 and B5),
     bit for bit, plus overflow cases that must be detected; each kernel's
     time, its plain version's, its bound and, for B3 and B8, one library
     call's.

  6. The one-shot device pipeline (sylph_tpu_torch/gpu/pipeline.py), each
     run with the launch counts set to 0 just before it: (q) bench.py's
     ``profile`` config, 64 batches of [65,536, 256] codes generated on
     the card (1.07 Gbp, c=200, k=31) against 1,024 genomes x 4,096
     k-mers (half of each genome drawn from the batches' survivors):
     ``sketch_batch`` (B6) per batch, ``condense_stream`` (B8),
     ``finish_profile`` (the merge join, [G, 256] histograms, the f32
     statistics); the histogram equals an exact oracle built through B7
     without any per-read capacity; ``profile_step``,
     ``sketch_batch_packed`` and ``finish_profile_batched`` (S = 8, the
     ``multisample`` config) agree with it, and the card's statistics with
     the CPU's; (s) the same batches under SYLPH_SEED_T=1: B9 launches, B6
     does not, the histogram is (q)'s; (r) bench.py's ``gtdb`` shape on
     the main path's grange engine: the main path's 7,158,278 reads in
     [65,536, 256] batches through B6 and B8, the occurrence-stream
     ``hist_device_stream`` (folded on the card) and the statistics; the
     histogram equals the B7 oracle and the sweep's probe is exact.
     B6, B9 and B10 are held against their plain versions at the [65,536,
     256] shape, at L=512 with c=2 (more than 128 survivors a read), and
     B10 at k=15.

  7. Each run with the launch counts set to 0 just before it and read just
     after: (t) the row repacks at the shapes of their JAX roles: B11
     (gpu/seeding.py::repack_rows) condenses the survivor stream of one
     [65,536, 256] batch of the real reads at B8's first (row, cap), B12
     (repack1_rows) chunk 0's column-major code stream at B3's; each
     launched and bit-identical to its plain version, at a 128-only
     geometry too, and B11 at cap 128 loses survivors visibly;
     (u) ``sylph_tpu_torch.kbench``'s table in-process (every microkernel
     of csrc/kbench.cu and the real B6/B9 lines, each bit-identical to its
     plain version; printed as one JSON line before the kernels line);
     (v) the grange layout cache: ``profile bucket.syldb bsample.sylsp``
     twice with SYLPH_GRANGE_CACHE set and the grange regime forced
     (GRANGE_MIN lowered for the phase): the first call builds and saves
     the layout, the second loads it; both TSVs equal (l)'s, the loaded
     layout equals the built one field by field, and the stage split shows
     the build, save and load seconds. Each phase prints its seconds.

Any failed check raises and the script exits non-zero. The last lines are
the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import time

import numpy as np

C, K = 200, 31
GENOMES = 100_000              # GTDB-scale genome count; never cut
KMERS_PER_GENOME = 7168        # the one cut allowed, to >= MIN_INDEX_KMERS
MIN_INDEX_KMERS = 1 << 27      # twice GRANGE_MIN: the grange regime by rule
SAMPLE_KMERS = 5_300_000       # sketch of a ~1.07 Gbp read set at c=200
DEEP_KMERS = 32_000_000
PLANTED = 512                  # genomes planted in each sample
READ_LEN = 150
READ_BASES = 1 << 30           # a typical Illumina metagenome, 1.07 Gbp
ABUNDANT = 64                  # genomes planted in the read set
SEED_BATCH = 1 << 16           # reads per seeding batch (device_sketch.py)
H100_BYTES_PER_S = 3.35e12     # HBM3, SXM data sheet
# INT32 issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper
# whitepaper); the data sheet has no integer rate outside the tensor cores
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 instructions per 64-bit equality and its conditional add in
# join.cu's lane loop: two ISETP (low word, then high word chained) and one
# predicated IADD
INT32_OPS_PER_COMPARE = 3
# int32 instructions a window of seed.cu at least issues: the 64-bit bugged
# Wang mix (seven steps of 64-bit shifts, adds and xors, 38), the canonical
# min (3 to compare, 2 to select) and the threshold test (2); the k-mer
# extraction is not counted
INT32_OPS_PER_WINDOW = 45
# the small-database phase: assemblies sketched with `sketch -g` (the merge
# regime), and a generated database in the bucket regime
ASSEMBLIES = 256               # genomes of 2-6 Mbp, about 1 Gbp in all
ASM_BP = (2_000_000, 6_000_000)
ASM_PLANTED = 32               # planted in small.sylsp
ASM_ABSENT = 2_000_000         # hashes of small.sylsp absent from the db
ASM_QUERY_FASTA = 16           # fasta inputs of the query check (k)
ASM_INDIVIDUAL = 8             # multi-contig genomes sketched with -i
BUCKET_GENOMES = 2048          # x BUCKET_KPG = 32,768,000 index k-mers:
BUCKET_KPG = 16_000            # 8 chunks, the last 3,407,872 live
BUCKET_SAMPLE_KMERS = 5_300_000
BUCKET_PLANTED = 128
BUCKET_CI_MAX = 256
THREADS = 8                    # the card's host has 8 cores
# the one-shot device pipeline (q)-(s): bench.py's profile config
# (bench.py:51-57) at full width, and its multisample config (S = 8)
PROFILE_BATCHES = 64           # x [65,536, 256] codes: 1.07 Gbp
PROFILE_READS = 1 << 16
PROFILE_LEN = 256
PROFILE_GENOMES = 1024         # x 4,096 k-mers, half of them survivors
PROFILE_KPG = 4096
PROFILE_H = 256                # the pipeline's DEFAULT_BUCKETS
MULTISAMPLE = 8
PIPE_CAP = min(128, 4 * PROFILE_LEN // C + 8)     # B6's lanes: 13


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kmers-per-genome", type=int, default=KMERS_PER_GENOME,
                    help="cut k-mers per genome (never the genome count) "
                    f"to fit the time limit; at least {MIN_INDEX_KMERS} "
                    "index k-mers in total")
    a = ap.parse_args(argv)
    if GENOMES * a.kmers_per_genome < MIN_INDEX_KMERS:
        ap.error(f"--kmers-per-genome {a.kmers_per_genome} gives fewer than "
                 f"{MIN_INDEX_KMERS} index k-mers")
    return a


def _fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


class _Stages(logging.Handler):
    """Collects the port's stage_timer records, (stage, seconds) in order,
    the ingest's per-phase busy seconds (its [ingest] record) and the
    genome seeding's row counts (its [genome rows] records)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.items = []
        self.ingest = {}
        self.genome_rows = [0, 0]       # rows, rows at the survivor cap

    def emit(self, rec):
        if isinstance(rec.msg, str) and rec.msg.startswith("[timing] %s:"):
            self.items.append((str(rec.args[0]), float(rec.args[1])))
        elif hasattr(rec, "ingest_busy"):
            self.ingest[str(rec.args[0])] = dict(
                rec.ingest_busy, wall=rec.ingest_wall)
        elif hasattr(rec, "genome_rows"):
            self.genome_rows[0] += rec.genome_rows[0]
            self.genome_rows[1] += rec.genome_rows[1]

    def total(self, prefix: str) -> float:
        return sum(s for n, s in self.items if n.startswith(prefix))

    def split(self) -> dict:
        """{stage: s} summed over the run, keys cut before " (", plus
        genome_rows [rows, rows at the survivor cap]."""
        out = {"genome_rows": self.genome_rows}
        for name, sec in self.items:
            key = name.split(" (")[0]
            out[key] = out.get(key, 0.0) + sec
        return out

    def per_sample(self) -> dict:
        """{sample path: {stage: s}}: a sample's load/sketch record names
        it (loads run on the cohort pool, beside another sample's
        processing); every other stage between two 'process sample'
        records belongs to the second one's sample."""
        out, cur, loads = {}, {}, {}
        for name, s in self.items:
            if name.startswith("process sample "):
                cur["process"] = s
                out[name[len("process sample "):]] = cur
                cur = {}
            elif name.startswith("load/sketch sample "):
                loads[name[len("load/sketch sample "):]] = s
            elif not name.startswith(("load database", "grange index")):
                key = name.split(" (")[0]
                cur[key] = cur.get(key, 0.0) + s
        for path, s in loads.items():
            out.setdefault(path, {})["load/sketch"] = s
        return out


# ---- data ---------------------------------------------------------------

def _make_world(a, work):
    """Write db.syldb, sample.sylsp and deep.sylsp; returns their paths,
    each sample's planted genome names, the database k-mers (genome g's
    are kmers[g*KPG:(g+1)*KPG]) and the planted genome ids."""
    from sylph_tpu_torch.core.types import GenomeSketch, SequencesSketch
    from sylph_tpu_torch.io import sylformat

    rng = np.random.default_rng(a.seed)
    G, KPG = GENOMES, a.kmers_per_genome
    thr = ((1 << 64) - 1) // C
    kmers = rng.integers(0, thr, size=G * KPG, dtype=np.uint64)
    empty = np.empty(0, np.uint64)
    genomes = [GenomeSketch(kmers[i * KPG:(i + 1) * KPG], empty,
                            f"g{i:06d}.fa", f"contig{i:06d}", C, K,
                            KPG * C, 30) for i in range(G)]
    db = os.path.join(work, "db.syldb")
    sylformat.write_syldb(db, genomes)
    del genomes

    picks = rng.choice(G, size=2 * PLANTED, replace=False)
    out = {}
    for name, total, plant, mults in (
            ("sample", SAMPLE_KMERS, picks[:PLANTED], range(1, 7)),
            ("deep", DEEP_KMERS, picks[PLANTED:], range(2, 13))):
        mults = np.asarray(list(mults))
        parts, counts = [], []
        for j, g in enumerate(np.sort(plant)):
            m = int(mults[j % mults.size])
            parts.append(kmers[g * KPG:(g + 1) * KPG])
            counts.append(1 + rng.poisson(m - 1, size=KPG))
        n_abs = total - PLANTED * KPG
        if n_abs < 0:
            _fail(f"{name}: {total} k-mers cannot hold {PLANTED} "
                  f"planted genomes of {KPG}")
        # uniform hashes; one colliding with the database's 7e8 k-mers
        # has probability ~1e-8 each, and would not change the checks
        parts.append(rng.integers(0, thr, size=n_abs, dtype=np.uint64))
        counts.append(rng.integers(1, 4, size=n_abs))
        sk = SequencesSketch(
            np.concatenate(parts), np.concatenate(counts).astype(np.uint32),
            C, K, f"{name}.fq", None, False, 150.0)
        path = os.path.join(work, f"{name}.sylsp")
        sylformat.write_sylsp(path, sk)
        out[name] = (path, {f"g{g:06d}.fa" for g in plant})
    return db, out, kmers, picks


def _rc31(v):
    """Reverse complements of 31-mers packed 2-bit MSB-first in uint64:
    complement, then reverse the 2-bit groups (pairs, nibbles, bytes)."""
    u = np.uint64
    x = ~v & u((1 << 62) - 1)
    m2, m4 = u(0x3333333333333333), u(0x0F0F0F0F0F0F0F0F)
    x = ((x >> u(2)) & m2) | ((x & m2) << u(2))
    x = ((x >> u(4)) & m4) | ((x & m4) << u(4))
    return x.byteswap() >> u(2)


def _usable(kmers_u64):
    """True where the hash inverts to a canonical 31-mer, which a read can
    then carry (about 1 in 8 of random hashes)."""
    from sylph_tpu_torch.kmer.hashing import inv_mm_hash64_np
    v = inv_mm_hash64_np(kmers_u64)
    return (v < np.uint64(1 << 62)) & (v <= _rc31(v))


def _make_reads(a, work, kmers, taken):
    """Write reads.fastq.gz: READ_BASES of 150-bp reads, each with one
    planted 31-mer whose canonical hash is a database k-mer. The usable
    k-mers of ABUNDANT genomes outside ``taken`` are planted once each and
    20% of them twice; the other reads carry singletons strided over the
    remaining genomes (about 1% of each, below every threshold). Returns
    (path, the abundant genome names, bases written, the reads' 2-bit
    codes [n_reads, READ_LEN] uint8 for the one-shot pipeline's (r))."""
    from sylph_tpu_torch.io import bgzf
    from sylph_tpu_torch.kmer.hashing import inv_mm_hash64_np

    rng = np.random.default_rng(a.seed + 1)
    KPG = a.kmers_per_genome
    n_reads = READ_BASES // READ_LEN
    free = np.setdiff1d(np.arange(GENOMES), taken)
    abundant = np.sort(rng.choice(free, size=ABUNDANT, replace=False))
    ab = np.concatenate([kmers[g * KPG:(g + 1) * KPG] for g in abundant])
    ab = ab[_usable(ab)]
    ab_plants = np.concatenate([ab, ab[rng.random(ab.size) < 0.20]])
    n_bg = n_reads - ab_plants.size
    stride = max(1, kmers.size // int(n_bg * 8.6))
    cand_idx = np.arange(0, kmers.size, stride)
    not_ab = np.ones(GENOMES, bool)
    not_ab[abundant] = False
    cand = kmers[cand_idx[not_ab[cand_idx // KPG]]]
    del cand_idx
    bg = cand[_usable(cand)]
    del cand
    if bg.size < n_bg:
        bg = np.tile(bg, -(-n_bg // max(1, bg.size)))
    plants = np.concatenate([ab_plants, bg[:n_bg]])
    del bg
    rng.shuffle(plants)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    tail = b"\n+\n" + b"I" * READ_LEN + b"\n"
    sh = (2 * (30 - np.arange(31, dtype=np.uint64)))[None, :]
    all_codes = np.empty((n_reads, READ_LEN), np.uint8)

    def text_chunks():
        for s in range(0, n_reads, 1 << 16):
            b = min(1 << 16, n_reads - s)
            codes = rng.integers(0, 4, size=(b, READ_LEN), dtype=np.uint8)
            v = inv_mm_hash64_np(plants[s:s + b])
            pc = ((v[:, None] >> sh) & np.uint64(3)).astype(np.uint8)
            off = rng.integers(0, READ_LEN - 31 + 1, size=b)
            np.put_along_axis(codes, off[:, None] + np.arange(31)[None, :],
                              pc, axis=1)
            all_codes[s:s + b] = codes
            seqs = bases[codes]
            yield b"".join(b"@r%d\n%s%s" % (s + i, seqs[i].tobytes(), tail)
                           for i in range(b))

    path = os.path.join(work, "reads.fastq.gz")
    bgzf.write(path, text_chunks(), level=1)
    return (path, {f"g{g:06d}.fa" for g in abundant}, n_reads * READ_LEN,
            all_codes)


# ---- main path ---------------------------------------------------------

def _drive(argv):
    """One CLI call in-process (cli.main, with --debug for the stage
    records), every launch count set to 0 just before it and read just
    after. Returns (launches, wall s, the call's _Stages, its device engine
    or None)."""
    import torch

    from sylph_tpu_torch import cli
    from sylph_tpu_torch.engine import runner
    from sylph_tpu_torch.gpu import _cuda

    engines = []
    make = runner._device_engine_for

    def keep(*args, **kw):
        engines.append(make(*args, **kw))
        return engines[-1]

    runner._device_engine_for = keep
    stages = _Stages()
    logging.getLogger("sylph").addHandler(stages)
    try:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main([*argv, "--debug"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
    finally:
        runner._device_engine_for = make
        logging.getLogger("sylph").removeHandler(stages)
    if rc != 0:
        _fail(f"{argv[0]} exited with {rc}")
    return launches, wall, stages, (engines[0] if engines else None)


def _main_path(db, reads, sketches, work):
    tsv = os.path.join(work, "out.tsv")
    (launches, wall, stages, dc), sketched = _capture_samples(
        lambda: _drive(["profile", db, reads, *sketches, "-o", tsv]))
    per = stages.per_sample()
    split = {
        "wall_s": wall,
        "load_s": stages.total("load database") + sum(
            v.get("load/sketch", 0.0) for k, v in per.items()
            if k != reads),
        "index_build_s": stages.total("grange index build"),
        "upload_s": stages.total("grange index upload"),
        "device_mask_s": stages.total("pass-1 prefilter"),
        "pass1_s": stages.total("pass-1 exact stats"),
        "pass2_s": stages.total("pass-2"),
    }
    print("main path: " + json.dumps(split))
    print("main path per sample: " + json.dumps(per))
    print("main path launches: " + json.dumps(launches))
    for kname in ("B1_fill", "B2_join_codes_compact", "B3_repack",
                  "B4_join_codes", "B7_seed", "B8_repack2"):
        if launches[kname] <= 0:
            _fail(f"{kname} was not launched on the main path")
    print("check (h): B1-B4, B7 and B8 launched on the main path")
    return dc, tsv, launches, sketched[reads], per, stages.ingest


def _oracle_hist(genomes, sk, sc, device, H=64):
    """[G, H] exact histograms by searchsorted of every index k-mer into
    the sorted sample (tests/test_grange.py's oracle, on the card).
    ``genomes`` holds GenomeSketches or plain k-mer arrays."""
    import torch
    G = len(genomes)
    kmers = [getattr(g, "genome_kmers", g) for g in genomes]
    skd = torch.from_numpy(sk.view(np.int64)).to(device)
    scd = torch.from_numpy(sc.astype(np.int64)).to(device)
    n = skd.numel()
    hist = torch.zeros(G * H, dtype=torch.int64, device=device)
    step = 8192
    for g0 in range(0, G, step):
        blk = kmers[g0:g0 + step]
        k = torch.from_numpy(np.concatenate(blk).view(np.int64)).to(device)
        sizes = torch.tensor([a.size for a in blk], device=device)
        gid = torch.repeat_interleave(
            torch.arange(g0, g0 + len(blk), device=device), sizes)
        idx = torch.searchsorted(skd, k)
        idxc = idx.clamp(max=max(n - 1, 0))
        cnt = torch.where((idx < n) & (skd[idxc] == k), scd[idxc], 0)
        live = cnt > 0
        hist += torch.bincount(gid[live] * H + cnt[live].clamp(max=H - 1),
                               minlength=G * H)
    return hist.view(G, H).cpu().numpy()


def _check_outputs(dc, samples, tsv):
    from sylph_tpu_torch.engine.prefilter import candidate_mask
    from sylph_tpu_torch.io import sylformat

    genomes = dc._genome_sketches
    n_kmers = np.array([g.genome_kmers.size for g in genomes], np.int64)
    mask_kw = dict(k=K, min_ani=0.95, min_number_kmers=50.0,
                   min_count_correct=3.0, no_adj=False)
    loaded = {}
    for name, (path, planted) in samples.items():
        smp = sylformat.read_sylsp(path)
        sk, sc = smp.sorted_view()
        got = dc.hists(smp)
        want = _oracle_hist(genomes, sk, sc, dc.device)
        if not np.array_equal(got, want):
            _fail(f"{name}: [G, 64] histogram differs from the oracle in "
                  f"{int((got != want).sum())} bins")
        host = candidate_mask(want, n_kmers, **mask_kw)
        dev = dc.candidates_mask(smp, mask_kw)
        if dev is None or (host & ~dev).any():
            _fail(f"{name}: device mask misses host candidates")
        print(f"check {name}: hist == oracle ({int(want.sum())} hits), "
              f"mask {int(dev.sum())} >= host {int(host.sum())}")
        loaded[name] = (smp, sk, sc, want)
    rows = {}
    with open(tsv) as f:
        next(f)
        for line in f:
            s, g = line.split("\t")[:2]
            rows.setdefault(s, set()).add(g)
    for name, (path, planted) in samples.items():
        got = rows.get(f"{name}.fq", set())
        if got != planted:
            _fail(f"{name}: TSV lists {len(got)} genomes, "
                  f"{len(got & planted)} of {len(planted)} planted")
        print(f"check {name}: TSV lists exactly the {len(planted)} planted "
              "genomes")
    return loaded


def _host_sketch(reads, work):
    """reads_host.sylsp: the read set sketched with the host C seeder
    (device None), the oracle of the card's sketch."""
    from sylph_tpu_torch.core.sketch_reads import sketch_sequences
    from sylph_tpu_torch.io import sylformat
    t0 = time.perf_counter()
    sk = sketch_sequences(reads, C, K, "reads_host", device=None)
    path = os.path.join(work, "reads_host.sylsp")
    sylformat.write_sylsp(path, sk)
    print(f"host sketch: {time.perf_counter() - t0:.3f} s "
          f"({sk.kmers.size} distinct k-mers)")
    return path


def _tsv_rows(tsv):
    """{sample column: [the rest of each row]} of a profile TSV."""
    rows = {}
    with open(tsv) as f:
        next(f)
        for line in f:
            s, rest = line.rstrip("\n").split("\t", 1)
            rows.setdefault(s, []).append(rest)
    return rows


def _check_reads(dc, reads, card, host_path, abundant, tsv, per, ingest):
    """Checks (d)-(g) of the raw-read sample, and its stage split. Returns
    reads_host.sylsp's (sorted kmers, counts, oracle histogram)."""
    import torch

    from sylph_tpu_torch.io import sylformat

    host = sylformat.read_sylsp(host_path)
    if not (np.array_equal(card.kmers, host.kmers)
            and np.array_equal(card.counts, host.counts)
            and card.mean_read_length == host.mean_read_length):
        _fail("(d) the card's sketch of the reads differs from the host "
              "seeder's")
    print(f"check (d): card sketch == host sketch ({card.kmers.size} "
          f"k-mers in insertion order, {int(card.counts.sum())} counted, "
          f"mean read length {card.mean_read_length})")
    eng = dc._grange
    counters = dict(eng.counters)
    if card._device_view is None or counters["device_view_sorts"] < 1 \
            or counters["mask_stream_masks"] < 1:
        _fail(f"(e) the raw-read sample missed the device view: {counters}")
    print("check (e): device view and stream-sweep mask used: "
          + json.dumps(counters))
    got = dc.hists(card)
    if eng.counters["device_view_sorts"] <= counters["device_view_sorts"]:
        _fail("(f) hists() did not take the device view")
    sk, sc = host.sorted_view()
    want = _oracle_hist(dc._genome_sketches, sk, sc, dc.device)
    if not np.array_equal(got, want):
        _fail(f"(f) device-view histogram differs from the oracle in "
              f"{int((got != want).sum())} bins")
    print(f"check (f): device-view hist == oracle ({int(want.sum())} hits)")
    rows = _tsv_rows(tsv)
    mine, theirs = rows.get(reads, []), rows.get(host.sample_name, [])
    listed = {r.split("\t")[0] for r in mine}
    if not mine or mine != theirs or not listed <= abundant:
        _fail(f"(g) reads TSV: {len(mine)} rows vs {len(theirs)} host rows; "
              f"{len(listed - abundant)} listed genomes not planted")
    print(f"check (g): reads TSV == reads_host TSV ({len(mine)} rows), all "
          f"of them among the {len(abundant)} abundant genomes")

    # stage split: the ingest's busy seconds per phase (summed over its
    # threads) beside its wall; the device sort timed alone on the card
    view = card._device_view
    _cuda_ms(lambda: eng._sorted_device_sample(view), 1)
    sort_ms = _cuda_ms(lambda: eng._sorted_device_sample(view), 5)
    t0 = time.perf_counter()
    np.argsort(card.kmers, kind="stable")
    host_sort_s = time.perf_counter() - t0
    mine_stages = per[reads]
    split = {
        "sketch": ingest.get(reads, {}),
        "load_sketch_s": mine_stages.get("load/sketch"),
        "stream_finalize_s": mine_stages.get("stream finalize"),
        "device_sort_ms": sort_ms,
        "host_sort_s": host_sort_s,
        "mask_sweep_s": mine_stages.get("device grange candidate mask"),
        "prefilter_s": mine_stages.get("pass-1 prefilter"),
        "pass1_s": mine_stages.get("pass-1 exact stats"),
        "pass2_s": mine_stages.get("pass-2 reassigned stats"),
    }
    print("raw-read sample stages: " + json.dumps(split))
    print("mask phase per sample (pass-1 prefilter s): " + json.dumps(
        {k: v.get("pass-1 prefilter") for k, v in per.items()}))
    torch.cuda.synchronize()
    return sk, sc, want


def _capture_samples(fn):
    """Run ``fn()`` with runner._load_sample hooked; returns (fn's result,
    {read file: the loaded sample})."""
    from sylph_tpu_torch.engine import runner

    got = {}
    load_sample = runner._load_sample

    def keep_sample(opts, rf, *args, **kw):
        got[rf[0]] = load_sample(opts, rf, *args, **kw)
        return got[rf[0]]

    runner._load_sample = keep_sample
    try:
        return fn(), got
    finally:
        runner._load_sample = load_sample


def _cohort_split(wall, stages, batched):
    """Wall and per-phase seconds of a cohort call, summed over its
    samples: loads, the host tables of the prefetch (sorts, padding),
    ``batched`` (the stage of its batched device work), the prefilter and
    the two statistics passes."""
    return dict(wall_s=wall, load_s=stages.total("load"),
                tables_s=stages.total("sample tables"),
                batched_s=stages.total(batched),
                prefilter_s=stages.total("pass-1 prefilter"),
                pass1_s=stages.total("pass-1 exact stats"),
                pass2_s=stages.total("pass-2"))


def _cohort_phase(dc, db, cohort, main_tsv, main_per):
    """(n): ``profile db.syldb`` of the three .sylsp samples at
    SYLPH_COHORT_DEPTH=3. The call reuses ``dc``, the main call's engine,
    through the runner._device_engine_for hook (this script's shortcut: the
    CLI builds an engine per call), so the 7.17e8-k-mer index is not built
    again. ``cohort`` maps each sample's path to its oracle histogram.
    Returns the call's launches."""
    from sylph_tpu_torch.engine import runner

    eng = dc._grange
    n_chunks = len(eng.gidx.chunk_keys)
    before = dict(eng.counters)
    tsv = main_tsv + ".cohort"
    make = runner._device_engine_for
    runner._device_engine_for = lambda *a, **kw: dc
    os.environ["SYLPH_COHORT_DEPTH"] = "3"
    try:
        (launches, wall, stages, _), samples = _capture_samples(
            lambda: _drive(["profile", db, *cohort, "-o", tsv]))
    finally:
        runner._device_engine_for = make
        del os.environ["SYLPH_COHORT_DEPTH"]
    delta = {k: eng.counters[k] - before[k] for k in before}
    n_b2b = launches["B2b_join_codes_compact_batched"]
    if n_b2b != n_chunks or delta["batched_sweeps"] != 1 or any(
            delta[k] for k in ("batched_rejected", "hists_sweeps",
                               "mask_stream_masks", "mask_stream_rejected")):
        _fail(f"(n) B2b launched {n_b2b} times for {n_chunks} chunks; "
              f"sweeps {delta}")
    main_rows, rows = _tsv_rows(main_tsv), _tsv_rows(tsv)
    for path, want in cohort.items():
        smp = samples[path]
        got = dc._cached(dc._hists_cache, smp)
        if got is None or not np.array_equal(got, want):
            _fail(f"(n) {path}: batched histogram differs from the oracle")
        name = smp.sample_name or smp.file_name
        if not rows.get(name) or rows[name] != main_rows.get(name):
            _fail(f"(n) {name}: {len(rows.get(name, []))} cohort rows vs "
                  f"{len(main_rows.get(name, []))} in the main call")
    print(f"check (n): one batched sweep of {len(cohort)} samples, B2b "
          f"launched once per chunk ({n_b2b}), no per-sample sweep; "
          "batched histograms == oracle; TSV rows == the main call's")
    print("cohort profile (depth 3): " + json.dumps(_cohort_split(
        wall, stages, "batched grange hists")))
    # the device sweeps alone, the tables already on the card: one batched
    # sweep against the three per-sample stream sweeps
    tables = [samples[p].sorted_view() for p in cohort]
    keys, w, n_live = eng.upload_tables(tables)
    ones = [eng.upload_sample(*t) for t in tables]
    print("cohort sweeps on the card: " + json.dumps(dict(
        batched_sweep_ms=_cuda_ms(
            lambda: eng.hist_device_stream_batched(keys, w, n_live), 2),
        per_sample_sweeps_ms=[_cuda_ms(
            lambda o=o: eng.hist_device_stream(*o), 2) for o in ones])))
    del keys, w, ones
    print("depth-1 mask phase of the same samples (pass-1 prefilter s): "
          + json.dumps({p: main_per.get(p, {}).get("pass-1 prefilter")
                        for p in cohort}))
    return launches


# ---- the small-database phase -------------------------------------------

def _make_assemblies(a, work):
    """ASSEMBLIES fasta files of ASM_BP bases each, written as assemblies
    are: 1 to 200 contigs, 80-column lines; every fourth genome carries
    three copies of 1-3 kb segments (the duplicate drop), every sixteenth
    N runs. Returns the paths."""
    rng = np.random.default_rng(a.seed + 2)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    paths = []
    for g in range(ASSEMBLIES):
        n = int(rng.integers(ASM_BP[0], ASM_BP[1] + 1))
        seq = acgt[rng.integers(0, 4, size=n, dtype=np.uint8)]
        if g % 4 == 0:
            for _ in range(3):
                ln = int(rng.integers(1000, 3001))
                src = seq[int(rng.integers(0, n - ln)):][:ln].copy()
                for _ in range(2):
                    at = int(rng.integers(0, n - ln))
                    seq[at:at + ln] = src
        if g % 16 == 3:
            for _ in range(int(rng.integers(2, 6))):
                ln = int(rng.integers(100, 5001))
                at = int(rng.integers(0, n - ln))
                seq[at:at + ln] = ord("N")
        n_contigs = int(rng.integers(1, 201))
        cuts = np.sort(rng.choice(n - 1, size=n_contigs - 1,
                                  replace=False) + 1)
        bounds = np.concatenate([[0], cuts, [n]])
        path = os.path.join(work, f"asm{g:03d}.fna")
        with open(path, "wb") as f:
            for ci in range(n_contigs):
                s = seq[bounds[ci]:bounds[ci + 1]]
                full = s.size // 80 * 80
                body = np.concatenate([s[:full].reshape(-1, 80), np.full(
                    (full // 80, 1), ord("\n"), np.uint8)], axis=1)
                f.write(b">asm%03d_contig%d\n" % (g, ci) + body.tobytes()
                        + s[full:].tobytes()
                        + (b"\n" if s.size > full else b""))
        paths.append(path)
    return paths


def _native_syldb(paths, out, individual):
    """The .syldb of ``paths`` sketched by the native C seeder on the host
    (device None), the oracle of the card's sketch."""
    from concurrent.futures import ThreadPoolExecutor

    from sylph_tpu_torch.core.sketch_genomes import (
        sketch_genome, sketch_genome_individual)
    from sylph_tpu_torch.io import sylformat

    def one(p):
        if individual:
            return sketch_genome_individual(C, K, p, 30, True, device=None)
        return [sketch_genome(C, K, p, 30, True, device=None)]

    with ThreadPoolExecutor(THREADS) as ex:
        sketches = [g for gs in ex.map(one, paths) for g in gs]
    sylformat.write_syldb(out, sketches)
    return out


def _same_file(a, b, what):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            _fail(f"{what}: {a} differs from {b}")


def _planted_sample(rng, genomes, picks, n_absent, name, work):
    """A .sylsp holding the full sketches of ``picks`` at mean
    multiplicities 1-6 and ``n_absent`` hashes absent from the database;
    returns (path, planted names, the loaded sketch)."""
    from sylph_tpu_torch.core.types import SequencesSketch
    from sylph_tpu_torch.io import sylformat

    thr = ((1 << 64) - 1) // C
    parts, counts = [], []
    for j, g in enumerate(np.sort(picks)):
        km = genomes[g].genome_kmers
        parts.append(km)
        counts.append(1 + rng.poisson(j % 6, size=km.size))
    parts.append(rng.integers(0, thr, size=n_absent, dtype=np.uint64))
    counts.append(rng.integers(1, 4, size=n_absent))
    sk = SequencesSketch(np.concatenate(parts),
                         np.concatenate(counts).astype(np.uint32), C, K,
                         f"{name}.fq", None, False, 150.0)
    path = os.path.join(work, f"{name}.sylsp")
    sylformat.write_sylsp(path, sk)
    return (path, {genomes[g].file_name for g in picks},
            sylformat.read_sylsp(path))


def _check_small(dc, genomes, smp, planted, tsv, tag):
    """hists == oracle, and the TSV lists exactly the planted genomes."""
    sk, sc = smp.sorted_view()
    got = dc.hists(smp)
    want = _oracle_hist(genomes, sk, sc, dc.device)
    if not np.array_equal(got, want):
        _fail(f"({tag}) [G, 64] histogram differs from the oracle in "
              f"{int((got != want).sum())} bins")
    listed = {r.split("\t")[0] for r in _tsv_rows(tsv).get(
        smp.file_name, [])}
    if listed != planted:
        _fail(f"({tag}) TSV lists {len(listed)} genomes, "
              f"{len(listed & planted)} of {len(planted)} planted")
    print(f"check ({tag}): hist == oracle ({int(want.sum())} hits), TSV "
          f"lists exactly the {len(planted)} planted genomes")


def _sketch_phase(a, work):
    """(i): `sketch -g` of the assemblies on the card, byte-identical to
    the native host path, plain and -i. Returns (the .syldb, the paths,
    the sketch path's launches)."""
    t0 = time.perf_counter()
    paths = _make_assemblies(a, work)
    gbp = sum(os.path.getsize(p) for p in paths) / 1e9
    print(f"generate assemblies: {time.perf_counter() - t0:.3f} s "
          f"({ASSEMBLIES} files, {gbp:.3f} GB of fasta)")
    small = os.path.join(work, "small")
    launches, wall, stages, _ = _drive(
        ["sketch", "-g", *paths, "-o", small, "-t", str(THREADS)])
    rows, at_cap = stages.genome_rows
    t0 = time.perf_counter()
    native = _native_syldb(paths, os.path.join(work, "native.syldb"), False)
    host_s = time.perf_counter() - t0
    _same_file(small + ".syldb", native, "(i) sketch -g")
    n_contigs = []
    for p in paths[:64]:
        with open(p, "rb") as f:
            n_contigs.append((f.read().count(b">"), p))
    multi = [p for _, p in sorted(n_contigs)[-ASM_INDIVIDUAL:]]
    indiv = os.path.join(work, "indiv")
    ilaunch, iwall, _, _ = _drive(["sketch", "-i", "-g", *multi, "-o", indiv,
                                   "-t", str(THREADS)])
    _same_file(indiv + ".syldb", _native_syldb(
        multi, os.path.join(work, "indiv_native.syldb"), True),
        "(i) sketch -i")
    if launches["B7_seed"] <= 0 or ilaunch["B7_seed"] <= 0:
        _fail("(m) B7 was not launched by sketch -g")
    print(f"check (i): sketch -g .syldb == native host .syldb "
          f"({os.path.getsize(native)} bytes), -i on {len(multi)} "
          "multi-contig genomes too")
    split = dict(card_sketch_s=wall, native_sketch_s=host_s,
                 individual_sketch_s=iwall, b7_launches=launches["B7_seed"],
                 rows=rows, rows_at_cap=at_cap)
    print("genome sketch: " + json.dumps(split))
    return small + ".syldb", paths, launches


def _merge_phase(a, work, db):
    """(j) profile in the merge regime; (k) query of fasta inputs. Returns
    the database's genomes and small.sylsp's (path, planted names, picks)."""
    from sylph_tpu_torch.io import sylformat

    rng = np.random.default_rng(a.seed + 3)
    genomes = sylformat.read_syldb(db)
    picks = rng.choice(len(genomes), size=ASM_PLANTED, replace=False)
    spath, planted, smp = _planted_sample(rng, genomes, picks, ASM_ABSENT,
                                          "small", work)
    tsv = os.path.join(work, "small.tsv")
    launches, wall, stages, dc = _drive(["profile", db, spath, "-o", tsv])
    if dc._grange is not None or dc._use_buckets:
        _fail("(j) small.syldb did not run in the merge regime")
    _check_small(dc, genomes, smp, planted, tsv, "j")
    print("merge profile: " + json.dumps(dict(
        wall_s=wall, index_kmers=int(dc.offsets[-1]),
        index_slots=int(dc.index.keys.size), **stages.split())))
    # (k): 8 planted and 8 other genomes as fasta inputs
    others = np.setdiff1d(np.arange(len(genomes)), picks)
    sel = np.concatenate([picks[:ASM_QUERY_FASTA // 2],
                          rng.choice(others, size=ASM_QUERY_FASTA // 2,
                                     replace=False)])
    names = {genomes[g].file_name for g in sel}
    qa, qb = (os.path.join(work, f"q{x}.tsv") for x in "ab")
    _drive(["query", db, spath, "-o", qa])
    qlaunch, qwall, _, _ = _drive(
        ["query", *[genomes[g].file_name for g in sel], spath, "-o", qb,
         "-t", str(THREADS)])
    ra = sorted(r for r in _tsv_rows(qa).get(smp.file_name, [])
                if r.split("\t")[0] in names)
    rb = sorted(_tsv_rows(qb).get(smp.file_name, []))
    if not rb or ra != rb or qlaunch["B7_seed"] <= 0:
        _fail(f"(k) fasta query: {len(rb)} rows vs {len(ra)} .syldb rows "
              f"(B7 {qlaunch['B7_seed']} launches)")
    print(f"check (k): query of {len(sel)} fasta genomes == the .syldb "
          f"query's rows for them ({len(rb)} rows; {qwall:.3f} s)")
    return genomes, (spath, planted, picks)


def _merge_cohort_phase(a, work, db, genomes, small):
    """(o): ``profile small.syldb`` of small.sylsp and three more planted
    samples (distinct planted sets) at the default merge depth of 8: one
    batched merge join, its counts equal to per-sample joins, and each
    sample's TSV rows list exactly its planted genomes."""
    import torch

    from sylph_tpu_torch.gpu.containment import (merge_join_counts,
                                                 merge_join_counts_batched)

    rng = np.random.default_rng(a.seed + 5)
    spath, planted, picks = small
    free = rng.permutation(np.setdiff1d(np.arange(len(genomes)), picks))
    paths, want = [spath], {spath: planted}
    for i in range(3):
        p, pl, _smp = _planted_sample(
            rng, genomes, free[i * ASM_PLANTED:(i + 1) * ASM_PLANTED],
            ASM_ABSENT, f"small{i + 1}", work)
        paths.append(p)
        want[p] = pl
    tsv = os.path.join(work, "small_cohort.tsv")
    (launches, wall, stages, dc), samples = _capture_samples(
        lambda: _drive(["profile", db, *paths, "-o", tsv]))
    if dc._grange is not None or dc._use_buckets or \
            dc.counters["batched_joins"] != 1:
        _fail(f"(o) not one batched merge join: {dc.counters}")
    smps = [samples[p] for p in paths]
    keys, wts = dc.upload_tables(smps)
    for smp in smps:
        got = dc._cached(dc._cache, smp)
        one = merge_join_counts(dc._index_dev, *dc.upload_table(smp))
        if got is None or not np.array_equal(got, one.cpu().numpy()):
            _fail(f"(o) {smp.file_name}: batched counts differ from the "
                  "per-sample join's")
    rows = _tsv_rows(tsv)
    for p in paths:
        name = samples[p].file_name
        listed = {r.split("\t")[0] for r in rows.get(name, [])}
        if listed != want[p]:
            _fail(f"(o) {name}: TSV lists {len(listed)} genomes, "
                  f"{len(listed & want[p])} of {len(want[p])} planted")
    idx = dc._index_dev
    tabs = [dc.upload_table(smp) for smp in smps]
    one_ms = sum(_cuda_ms(lambda t=t: merge_join_counts(idx, *t), 3)
                 for t in tabs)
    split = dict(_cohort_split(wall, stages, "batched containment join"),
                 batched_join_ms=_cuda_ms(lambda: merge_join_counts_batched(
                     idx, keys, wts), 3),
                 per_sample_joins_ms=one_ms, table_slots=int(keys.shape[1]))
    print(f"check (o): one batched merge join of {len(smps)} samples == "
          "per-sample joins; each TSV lists exactly its planted genomes")
    print("merge cohort profile (depth 8): " + json.dumps(split))
    torch.cuda.synchronize()


def _bucket_phase(a, work):
    """(l) and (m): profile against a generated database in the bucket
    regime. Returns (engine, the loaded sample, launches, (database,
    sample, TSV) paths)."""
    from sylph_tpu_torch.core.types import GenomeSketch
    from sylph_tpu_torch.io import sylformat

    rng = np.random.default_rng(a.seed + 4)
    thr = ((1 << 64) - 1) // C
    kmers = rng.integers(0, thr, size=BUCKET_GENOMES * BUCKET_KPG,
                         dtype=np.uint64)
    empty = np.empty(0, np.uint64)
    genomes = [GenomeSketch(kmers[i * BUCKET_KPG:(i + 1) * BUCKET_KPG],
                            empty, f"b{i:05d}.fa", f"contig{i:05d}", C, K,
                            BUCKET_KPG * C, 30)
               for i in range(BUCKET_GENOMES)]
    db = os.path.join(work, "bucket.syldb")
    sylformat.write_syldb(db, genomes)
    picks = rng.choice(BUCKET_GENOMES, size=BUCKET_PLANTED, replace=False)
    spath, planted, smp = _planted_sample(
        rng, genomes, picks, BUCKET_SAMPLE_KMERS - BUCKET_PLANTED *
        BUCKET_KPG, "bsample", work)
    tsv = os.path.join(work, "bucket.tsv")
    launches, wall, stages, dc = _drive(["profile", db, spath, "-o", tsv])
    n_chunks = len(dc._bchunks)
    cis = [int(ch.key.shape[1]) for ch in dc._bchunks]
    if not dc._use_buckets or dc._grange is not None or n_chunks != 8:
        _fail(f"(l) bucket.syldb ran with {n_chunks} bucketed chunks")
    if max(cis) > BUCKET_CI_MAX:
        _fail(f"(l) chunk CI {cis} above {BUCKET_CI_MAX}")
    _check_small(dc, genomes, smp, planted, tsv, "l")
    if launches["B1_fill"] != n_chunks or \
            launches["B5p_bucket_join"] != n_chunks:
        _fail(f"(m) B1 {launches['B1_fill']} and B5' "
              f"{launches['B5p_bucket_join']} launches, not one per chunk "
              f"({n_chunks})")
    print(f"check (l): {n_chunks} chunks, CI {cis}, last chunk "
          f"{dc._bchunks[-1].m} live k-mers")
    _bucket_vs_merge(dc, smp)
    print(f"check (m): B1 and B5' launched once per chunk ({n_chunks})")
    print("bucket profile: " + json.dumps(dict(wall_s=wall,
                                               **stages.split())))
    return dc, smp, launches, (db, spath, tsv)


def _bucket_vs_merge(dc, smp):
    """The bucket regime's [M] counts against the merge join's on the same
    index and table (they must be equal), and both timed on the card: does
    the bucket layout pay on the H100 at this size?"""
    import torch

    from sylph_tpu_torch.gpu.containment import merge_join_counts

    n = int(smp.kmers.size)
    skey, sw = dc.upload_table(smp)
    idx = torch.from_numpy(dc.index.keys).to(dc.device)
    got = dc.device_counts(skey, sw, n)
    if not torch.equal(got, merge_join_counts(idx, skey, sw)):
        _fail("(l) bucket-regime counts differ from the merge join's")
    split = dict(
        bucket_join_ms=_cuda_ms(lambda: dc.device_counts(skey, sw, n), 5),
        merge_join_ms=_cuda_ms(lambda: merge_join_counts(idx, skey, sw), 5))
    print("check (l): bucket counts == merge-join counts on the same index; "
          + json.dumps(split))


def _small_db_kernels(dc, smp, paths, launches, sk_launches, record):
    """B5' and B1 at chunk 0 of the bucket regime with bsample's table; B7
    on a [2048, 4096] batch of genome rows."""
    import torch

    from sylph_tpu_torch.engine import device_sketch as ds
    from sylph_tpu_torch.gpu import bucket_fill as bf
    from sylph_tpu_torch.gpu import bucket_join as bj
    from sylph_tpu_torch.gpu import seeding as sd
    from sylph_tpu_torch.io.fastx import parse_fastx

    ch = dc._bchunks[0]
    n = int(smp.kmers.size)
    skey, sw = dc.upload_table(smp)
    B, CI = ch.key.shape
    CS = bj.sample_cs(n, B)
    fkw = dict(width=ch.width, B=B, CS=CS)
    got = bf.bucket_fill(skey, sw, 0, **fkw)
    err = _same("B1_fill (whole range)", got,
                bj._sample_to_buckets(skey, sw, base=0, **fkw))
    record("B1_fill (whole range)", "fill.cu",
           "sylph_tpu/tpu/bucket_fill.py:278", err,
           _cuda_ms(lambda: bf.bucket_fill(skey, sw, 0, **fkw), 20),
           _cuda_ms(lambda: bj._sample_to_buckets(skey, sw, base=0, **fkw),
                    3),
           _live_entries(sw) * 12 + B * CS * 12, 0,
           n_launches=launches["B1_fill"])
    dk, dw = got
    ikey = ch.key
    got = bj.bucket_counts(ikey, dk, dw)
    err = _same("B5p_bucket_join", (got,),
                (bj.join_counts_plain(ikey, dk, dw),))
    live = int((dw > 0).sum())
    print(f"B5' at chunk 0: [{B}, {CI}] x {CS} lanes, {live} of {B * CS} "
          f"lanes live ({1 - live / (B * CS):.3f} pad share)")
    record("B5p_bucket_join", "join.cu", "sylph_tpu/tpu/bucket_join.py:377",
           err, _cuda_ms(lambda: bj.bucket_counts(ikey, dk, dw), 20),
           _cuda_ms(lambda: bj.join_counts_plain(ikey, dk, dw), 2),
           B * CI * 8 + B * CS * 12 + B * CI * 4,
           _live_compares(ikey, dw) * INT32_OPS_PER_COMPARE,
           n_launches=launches["B5p_bucket_join"])

    # B7 on the first 2048 genome rows of the assemblies, in order
    parts = []
    for p in paths:
        px = parse_fastx(p)
        cid, off, rlen = ds._genome_rows(px, K)
        padded = np.concatenate([px.codes, np.zeros(ds._GBLOCK, np.uint8)])
        parts.append(ds._gather_rows(padded, px.starts[cid] + off, rlen,
                                     ds._GBLOCK))
        if sum(b.shape[0] for b, _ in parts) >= ds._GROWS:
            break
    bases = np.concatenate([b for b, _ in parts])[:ds._GROWS]
    blens = np.concatenate([n_ for _, n_ in parts])[:ds._GROWS]
    packed, lens = ds._upload_batch(bases, blens, dc.device)
    N, L = bases.shape
    got = sd.seed_packed(packed, lens, c=C, k=K)
    err = _same("B7_seed (genome rows)", got,
                sd.seed_packed_plain(packed, lens, c=C, k=K))
    record("B7_seed (genome rows)", "seed.cu",
           "sylph_tpu/tpu/pallas_seeding.py:152", err,
           _cuda_ms(lambda: sd.seed_packed(packed, lens, c=C, k=K), 20),
           _cuda_ms(lambda: sd.seed_packed_plain(packed, lens, c=C, k=K), 3),
           N * L // 4 + N * 4 + N * L * 9,
           _live_windows(lens, K) * INT32_OPS_PER_WINDOW,
           n_launches=sk_launches["B7_seed"])


# ---- the one-shot device pipeline ----------------------------------------

def _b7_survivors(batches, lens, cap=None):
    """(sorted distinct survivor keys uint64, their counts, each read's
    survivor count) of read batches through B7, keeping each read's first
    ``cap`` survivors in window order (all of them when None): the exact
    oracle of the fused kernels' output at that capacity."""
    import torch

    from sylph_tpu_torch.gpu import pipeline as pl
    from sylph_tpu_torch.gpu.seeding import seed_packed
    parts, per_read = [], []
    for b, n in zip(batches, lens):
        h, keep = seed_packed(pl._pack_words(b), n, c=C, k=K)
        if cap is not None:
            keep = keep & (torch.cumsum(keep, dim=1) <= cap)
        parts.append(h[keep])
        per_read.append(keep.sum(dim=1))
    sk, sc = torch.unique(torch.cat(parts), return_counts=True)
    return (sk.cpu().numpy().view(np.uint64), sc.cpu().numpy(),
            torch.cat(per_read))


def _stats_close(name, got, want):
    """Integer and boolean stats fields equal, float fields to rtol 1e-5
    (f32 pow, exp and gammainc differ between devices in the last bits)."""
    import torch
    for f in ("contained", "n_inliers", "median_cov", "lam_valid", "valid"):
        if not torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()):
            _fail(f"{name}: stats field {f} differs")
    for f in ("naive_ani", "final_ani", "final_cov", "lam", "mean_cov"):
        a, b = getattr(got, f).cpu(), getattr(want, f).cpu()
        if a.dtype != torch.float32 or not torch.allclose(
                a, b, rtol=1e-5, atol=0.0, equal_nan=True):
            _fail(f"{name}: stats field {f} beyond rtol 1e-5")


def _timed(fn):
    """(fn's result, host seconds to the end of its device work)."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _pipeline_run(batches, lens, ikey, gids, nk, live, kw,
                  flat=lambda p: p.reshape(-1)):
    """sketch_batch per batch, condense_stream (B8), finish_profile, with
    every launch count set to 0 just before and read just after. Each
    batch's keys enter the stream read by read (``flat``; B9's
    read-per-column layout is transposed first, see check (s)). Returns
    (hist, stats, the per-batch keys, launches, stage seconds)."""
    import torch

    from sylph_tpu_torch.gpu import _cuda
    from sylph_tpu_torch.gpu import pipeline as pl
    from sylph_tpu_torch.gpu.bucket_fill import condense_stream

    _cuda.reset_launches()
    parts, sketch_s = _timed(lambda: [pl.sketch_batch(b, n, c=C, k=K)[0]
                                      for b, n in zip(batches, lens)])
    cond, condense_s = _timed(lambda: condense_stream(
        torch.cat([flat(p) for p in parts]), live))
    (hist, st), finish_s = _timed(lambda: pl.finish_profile(
        cond, ikey, gids, nk, **kw))
    launches = dict(_cuda.LAUNCHES)
    stages = dict(sketch_s=sketch_s, condense_s=condense_s,
                  finish_s=finish_s, stream_slots=int(cond.numel()),
                  live=int((cond != -1).sum()))
    return hist, st, parts, launches, stages


def _profile_phase(a, dev):
    """(q) bench.py's profile config on the card through the one-shot
    pipeline, and (s) the same batches under SYLPH_SEED_T=1 (B9). Returns
    (one batch, its lengths, (q)'s launches, (s)'s launches)."""
    import torch

    from sylph_tpu_torch.gpu import pipeline as pl
    from sylph_tpu_torch.gpu.bucket_fill import condense_stream
    from sylph_tpu_torch.gpu.containment import build_host_index
    from sylph_tpu_torch.gpu.seed_pack import cap_rows_t
    from sylph_tpu_torch.gpu.stats import stats_from_histograms

    N, L = PROFILE_READS, PROFILE_LEN
    gen = torch.Generator(device=dev)
    gen.manual_seed(a.seed + 6)
    t0 = time.perf_counter()
    batches = [torch.randint(0, 4, (N, L), generator=gen, dtype=torch.uint8,
                             device=dev) for _ in range(PROFILE_BATCHES)]
    lens = [torch.full((N,), L, dtype=torch.int32, device=dev)] * len(batches)
    sk, sc, per_read = _b7_survivors(batches, lens)
    rng = np.random.default_rng(a.seed + 6)
    thr = ((1 << 64) - 1) // C
    half = PROFILE_KPG // 2
    genomes = [np.concatenate([
        sk[rng.choice(sk.size, size=half, replace=False)],
        rng.integers(0, thr, size=PROFILE_KPG - half, dtype=np.uint64)])
        for _ in range(PROFILE_GENOMES)]
    idx = build_host_index(genomes)
    ikey, gids, nk = (torch.from_numpy(x).to(dev) for x in (
        idx.keys, idx.genome_ids, idx.n_kmers))
    want = _oracle_hist(genomes, sk, sc, dev, H=PROFILE_H)
    want[:, 0] = idx.n_kmers - want[:, 1:].sum(axis=1)   # not contained
    over = {c: int((per_read > c).sum()) for c in (PIPE_CAP, 16)}
    setup_s = time.perf_counter() - t0
    kw = dict(k=K, n_genomes=PROFILE_GENOMES, n_buckets=PROFILE_H,
              min_ani=0.5)

    # (q): B6 per batch, B8, the merge join and the statistics, once to
    # warm up (first-use allocations, the f32 gammainc kernel's runtime
    # compile), then measured
    _pipeline_run(batches[:2], lens, ikey, gids, nk, 1.0, kw)
    hist, st, parts, q_launches, stages = _pipeline_run(
        batches, lens, ikey, gids, nk, (L - K + 1) / C / PIPE_CAP, kw)
    if q_launches["B6_seed_pack"] != len(batches) or \
            q_launches["B8_repack2"] <= 0:
        _fail(f"(q) B6 {q_launches['B6_seed_pack']} and B8 "
              f"{q_launches['B8_repack2']} launches for {len(batches)} "
              "batches")
    if stages["live"] != int(sc.sum()) or \
            not np.array_equal(hist.cpu().numpy(), want):
        _fail(f"(q) {stages['live']} of {int(sc.sum())} survivors kept "
              f"({over[PIPE_CAP]} reads past {PIPE_CAP}); the [G, "
              f"{PROFILE_H}] histogram differs from the B7 oracle in "
              f"{int((hist.cpu().numpy() != want).sum())} bins")
    h1, s1 = pl.profile_step(batches[0], lens[0], ikey, gids, nk, c=C, **kw)
    k0, n0 = pl.sketch_batch(batches[0], lens[0], c=C, k=K)
    h2, s2 = pl.finish_profile(k0, ikey, gids, nk, **kw)
    kp, npk = pl.sketch_batch_packed(pl._pack_words(batches[0]), lens[0],
                                     c=C, k=K)
    if not (torch.equal(h1, h2) and torch.equal(kp, k0)
            and int(npk) == int(n0) == int((k0 != -1).sum())):
        _fail("(q) profile_step or sketch_batch_packed differs from "
              "sketch_batch + finish_profile")
    _stats_close("(q) profile_step", s1, s2)
    smp = torch.stack([p.reshape(-1) for p in parts[:MULTISAMPLE]])
    hb, sb = pl.finish_profile_batched(smp, ikey, gids, nk, **kw)
    for i in range(MULTISAMPLE):
        hs, ss = pl.finish_profile(smp[i], ikey, gids, nk, **kw)
        if not torch.equal(hb[i], hs):
            _fail(f"(q) finish_profile_batched row {i} differs")
        _stats_close(f"(q) finish_profile_batched row {i}",
                     type(sb)(*[f[i] for f in sb]), ss)
    _stats_close("(q) card stats vs CPU", st, stats_from_histograms(
        hist.cpu(), nk.cpu(), k=K, min_ani=0.5))
    print(f"check (q): {len(batches)} batches of [{N}, {L}] through B6 "
          f"({q_launches['B6_seed_pack']} launches) and B8 "
          f"({q_launches['B8_repack2']}); [G, {PROFILE_H}] hist == B7 "
          f"oracle ({int(want[:, 1:].sum())} hits, {stages['live']} "
          "survivors); profile_step, sketch_batch_packed, "
          f"finish_profile_batched (S = {MULTISAMPLE}) and the CPU stats "
          "agree")
    gbp = len(batches) * N * L / 1e9
    stages.update(
        setup_s=setup_s, gbp=gbp, sketch_gbp_per_s=gbp / stages["sketch_s"],
        batched_ms=_cuda_ms(lambda: pl.finish_profile_batched(
            smp, ikey, gids, nk, **kw), 2),
        singles_ms=sum(_cuda_ms(lambda r=r: pl.finish_profile(
            r, ikey, gids, nk, **kw), 2) for r in smp))
    print("one-shot profile (q): " + json.dumps(stages))
    del smp, hb, parts

    # (s): the transposed kernel (B9) on the same batches. Its [16, N]
    # keys hold every read's first survivor in row 0 (about 68% live), the
    # second in row 1, ...: flattened row by row, as bench.py and the JAX
    # sharded step flatten them, condense_stream's windows sized by the
    # mean density (7%) overflow in the first rows; read by read they are
    # as even as B6's
    flag = pl._USE_TRANSPOSED_SEED
    pl._USE_TRANSPOSED_SEED = True
    cap_t = cap_rows_t(L, C)
    live_t = (L - K + 1) / C / cap_t
    try:
        _pipeline_run(batches[:2], lens, ikey, gids, nk, 1.0, kw,
                      flat=lambda p: p.t().reshape(-1))
        hist_t, _st, parts, s_launches, s_stages = _pipeline_run(
            batches, lens, ikey, gids, nk, live_t, kw,
            flat=lambda p: p.t().reshape(-1))
    finally:
        pl._USE_TRANSPOSED_SEED = flag
    s_stages["row_major_kept"] = int((condense_stream(torch.cat(
        [p.reshape(-1) for p in parts]), live_t) != -1).sum())
    if s_launches["B9_seed_pack_t"] != len(batches) or \
            s_launches["B6_seed_pack"] != 0:
        _fail(f"(s) B9 {s_launches['B9_seed_pack_t']} and B6 "
              f"{s_launches['B6_seed_pack']} launches")
    cnt = torch.cat([(p != -1).sum(dim=0) for p in parts])
    reach = {c: int((cnt >= c).sum()) for c in (PIPE_CAP, cap_t)}
    # B9 keeps each read's first cap_t survivors: held against the B7
    # oracle cut at that capacity, whatever the reads' survivor counts
    sk_t, sc_t, _ = _b7_survivors(batches, lens, cap=cap_t)
    want_t = _oracle_hist(genomes, sk_t, sc_t, dev, H=PROFILE_H)
    want_t[:, 0] = idx.n_kmers - want_t[:, 1:].sum(axis=1)
    if s_stages["live"] != int(sc_t.sum()) or \
            not np.array_equal(hist_t.cpu().numpy(), want_t):
        _fail(f"(s) {s_stages['live']} of {int(sc_t.sum())} survivors kept;"
              f" the B9 histogram differs from the B7 oracle cut at {cap_t} "
              f"in {int((hist_t.cpu().numpy() != want_t).sum())} bins")
    same_q = bool(torch.equal(hist_t, hist))
    print(f"check (s): B9 launched {s_launches['B9_seed_pack_t']} times, B6 "
          f"none; hist == B7 oracle cut at {cap_t} survivors a read "
          f"(read-major stream), == (q)'s: {same_q}; flattened row by row "
          f"condense_stream kept {s_stages['row_major_kept']} of "
          f"{s_stages['live']} survivors; reads reaching {PIPE_CAP} survivors: "
          f"{reach[PIPE_CAP]}, reaching {cap_t}: {reach[cap_t]} (past "
          f"{PIPE_CAP} in the B7 oracle: {over[PIPE_CAP]}, past 16: "
          f"{over[16]})")
    print("one-shot profile, SYLPH_SEED_T=1 (s): " + json.dumps(s_stages))
    return batches[0], lens[0], q_launches, s_launches


def _gtdb_pipeline_phase(dc, codes):
    """(r): bench.py's gtdb shape on the main path's grange engine: the
    main path's 7,158,278 reads packed into [65,536, 256] batches (lengths
    150, the last batch padded with length-0 rows), sketch_batch (B6) per
    batch, condense_stream (B8), the occurrence-stream hist_device_stream
    (folded on the card) and the statistics."""
    import torch

    from sylph_tpu_torch.gpu import _cuda
    from sylph_tpu_torch.gpu import pipeline as pl
    from sylph_tpu_torch.gpu.bucket_fill import condense_stream
    from sylph_tpu_torch.gpu.grange import fold_stream
    from sylph_tpu_torch.gpu.stats import stats_from_histograms

    eng = dc._grange
    dev = dc.device
    N, L = PROFILE_READS, PROFILE_LEN
    t0 = time.perf_counter()
    batches, lens = [], []
    for s in range(0, codes.shape[0], N):
        blk = torch.from_numpy(codes[s:s + N]).to(dev)
        b = torch.zeros((N, L), dtype=torch.uint8, device=dev)
        b[:blk.shape[0], :READ_LEN] = blk
        n = torch.zeros(N, dtype=torch.int32, device=dev)
        n[:blk.shape[0]] = READ_LEN
        batches.append(b)
        lens.append(n)
    sk, sc, per_read = _b7_survivors(batches, lens)
    genomes = dc._genome_sketches
    G = len(genomes)
    want = _oracle_hist(genomes, sk, sc, dev)
    nk = torch.tensor([g.genome_kmers.size for g in genomes], device=dev)
    setup_s = time.perf_counter() - t0

    _cuda.reset_launches()
    out, sketch_s = _timed(lambda: [pl.sketch_batch(b, n, c=C, k=K)
                                    for b, n in zip(batches, lens)])
    parts = [keys for keys, _n in out]
    # every read carries a planted index k-mer, which survives: the live
    # share is measured (about 1.6 survivors a read, not the 0.6 of random
    # reads), as bench.py's gtdb config measures it, since capacities
    # sized below it would drop survivors
    n_live = int(torch.stack([n for _k, n in out]).sum())
    cond, condense_s = _timed(lambda: condense_stream(
        torch.cat([p.reshape(-1) for p in parts]),
        n_live / (len(parts) * N * PIPE_CAP)))
    (hist, probe, P), stream_s = _timed(lambda: eng.hist_device_stream(
        cond))
    launches = dict(_cuda.LAUNCHES)
    # the host-side spill list joins the pipeline's own folded stream, as
    # a caller of the one-shot path would join it, never the oracle's
    fk, fw = fold_stream(cond)
    got = eng._fold_heavy(hist.cpu().numpy()) + eng._spill_hist(
        fk.cpu().numpy().view(np.uint64), fw.cpu().numpy())
    full = torch.from_numpy(got).to(dev)
    st, stats_s = _timed(lambda: stats_from_histograms(full, nk, k=K,
                                                       min_ani=0.95))
    if launches["B6_seed_pack"] != len(batches) or \
            launches["B8_repack2"] <= 0:
        _fail(f"(r) B6 {launches['B6_seed_pack']} and B8 "
              f"{launches['B8_repack2']} launches for {len(batches)} "
              "batches")
    kept = int((cond != -1).sum())
    if n_live != int(sc.sum()) or kept != n_live:
        _fail(f"(r) {n_live} survivors sketched, {kept} after condense_stream"
              f", {int(sc.sum())} in the B7 oracle")
    if int(probe[0]) != 0 or int(probe[1]) > P:
        _fail(f"(r) the stream sweep's probe is not exact: "
              f"{probe.tolist()} with P={P}")
    if not np.array_equal(got, want):
        _fail(f"(r) [G, 64] histogram differs from the B7 oracle in "
              f"{int((got != want).sum())} bins")
    live = st.contained > 0
    if not bool(torch.isfinite(st.final_ani[live]).all()):
        _fail("(r) non-finite ANI for a contained genome")
    at_cap = sum(int((p[:, PIPE_CAP - 1] != -1).sum()) for p in parts)
    fold_ms = _cuda_ms(lambda: fold_stream(cond), 3)
    sweep_ms = _cuda_ms(lambda: eng.hist_device_stream(fk, fw), 3)
    split = dict(
        reads=int(codes.shape[0]), batches=len(batches), setup_s=setup_s,
        sketch_s=sketch_s, condense_s=condense_s,
        fold_and_sweep_s=stream_s, fold_and_sort_ms=fold_ms,
        sweep_ms=sweep_ms, stats_s=stats_s, stream_slots=int(cond.numel()),
        survivors=int(sc.sum()), distinct=int(sk.size), P=P,
        spilled_slots=int(eng.gidx.spill_kmers.size),
        reads_at_cap=at_cap,
        reads_past_cap=int((per_read > PIPE_CAP).sum()),
        valid_genomes=int(st.valid.sum()))
    print(f"check (r): {len(batches)} batches through B6 "
          f"({launches['B6_seed_pack']}) and B8 ({launches['B8_repack2']}),"
          f" occurrence-stream sweep probe exact, [G, 64] hist == B7 "
          f"oracle ({int(want[:, 1:].sum())} hits over {G} genomes)")
    print("one-shot gtdb (r): " + json.dumps(split))
    return launches


def _pipeline_kernels(dev, batch, lens, q_launches, s_launches, record):
    """B6, B9 and B10 on one [65,536, 256] batch of (q) against their plain
    versions, plus an overflow case (L = 512, c = 2: more than 128
    survivors a read) and B10 at k = 15."""
    import torch

    from sylph_tpu_torch.gpu import seed_pack as sp

    N, L = batch.shape
    ops = _live_windows(lens, K) * INT32_OPS_PER_WINDOW
    io = N * L + N * 4
    bt = batch.t().contiguous()
    cap_t = sp.cap_rows_t(L, C)
    cases = (
        ("B6_seed_pack", ":283", q_launches["B6_seed_pack"], N * PIPE_CAP,
         lambda: sp.seed_pack(batch, lens, c=C, k=K, lanes=PIPE_CAP),
         lambda: sp.seed_pack_plain(batch, lens, c=C, k=K, lanes=PIPE_CAP)),
        ("B6_seed_pack (128 lanes)", ":283", 0, N * 128,
         lambda: sp.seed_pack(batch, lens, c=C, k=K),
         lambda: sp.seed_pack_plain(batch, lens, c=C, k=K)),
        ("B9_seed_pack_t", ":501", s_launches["B9_seed_pack_t"], N * cap_t,
         lambda: sp.seed_pack_t(bt, lens, c=C, k=K),
         lambda: sp.seed_pack_t_plain(bt, lens, c=C, k=K)),
        ("B10_seed_compact", ":183", 0, N * 128,
         lambda: sp.seed_compact(batch, lens, c=C, k=K),
         lambda: sp.seed_compact_plain(batch, lens, c=C, k=K)))
    for name, line, n_launch, out_slots, kern, plain in cases:
        err = _same(name, (kern(),), (plain(),))
        record(name, "seed_pack.cu", "sylph_tpu/tpu/pallas_seeding.py"
               + line, err, _cuda_ms(kern, 20), _cuda_ms(plain, 3),
               io + out_slots * 8, ops, n_launches=n_launch)
    print("B9's transpose of the batch (the pipeline's, before B9): "
          f"{_cuda_ms(lambda: batch.t().contiguous(), 20):.4f} ms")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    ob = torch.randint(0, 4, (4096, 512), generator=gen, dtype=torch.uint8,
                       device=dev)
    ol = torch.full((4096,), 512, dtype=torch.int32, device=dev)
    got = sp.seed_pack(ob, ol, c=2, k=K)
    _same("B6 overflow", (got,), (sp.seed_pack_plain(ob, ol, c=2, k=K),))
    _same("B10 overflow", (sp.seed_compact(ob, ol, c=2, k=K),),
          (sp.seed_compact_plain(ob, ol, c=2, k=K),))
    obt = ob.t().contiguous()
    got_t = sp.seed_pack_t(obt, ol, c=2, k=K)
    _same("B9 overflow", (got_t,), (sp.seed_pack_t_plain(obt, ol, c=2,
                                                         k=K),))
    _same("B10 k=15", (sp.seed_compact(batch, lens, c=C, k=15),),
          (sp.seed_compact_plain(batch, lens, c=C, k=15),))
    full = int(((got != -1).sum(dim=1) == 128).sum())
    if full == 0:
        _fail("B6 overflow case kept no read at 128 survivors")
    print(f"overflow check: L=512, c=2: {full} of 4096 reads at B6's 128 "
          f"lanes, up to {int((got_t != -1).sum(dim=0).max())} in B9's "
          f"{got_t.shape[0]} rows; B6, B9, B10 (and B10 at k=15) "
          "bit-identical")


# ---- kernels against their plain versions --------------------------------
#
# A bound counts the work this run's data needs, not the padded shapes: the
# live sample entries a fill reads, the compares of live index slots with
# the live lanes they meet, the windows of each row's real length. Bytes
# count every input grid read once and every output written once.

def _live_entries(w) -> int:
    """Entries of a sample table or slice with a nonzero weight."""
    return int((w > 0).sum())


def _live_compares(ikey, dw, nt: int = 1, tile: int = 0) -> int:
    """Equality tests a compare kernel needs: per index row, its live slots
    times the live lanes they are compared with (tiled layout: column tile
    t against lane group t, the overflow columns against every lane)."""
    import torch
    il = (ikey != -1).to(torch.int64)
    ll = (dw > 0).to(torch.int64)
    if nt <= 1:
        return int((il.sum(1) * ll.sum(1)).sum())
    cs = ll.shape[1] // nt
    n = (il[:, nt * tile:].sum(1) * ll.sum(1)).sum()
    for t in range(nt):
        n += (il[:, t * tile:(t + 1) * tile].sum(1)
              * ll[:, t * cs:(t + 1) * cs].sum(1)).sum()
    return int(n)


def _live_windows(lens, k: int) -> int:
    """k-mer windows in rows of these lengths."""
    import torch
    return int(torch.clamp(lens.to(torch.int64) - (k - 1), min=0).sum())


def _cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _same(name, got, want):
    """max |got - want| over every output (0 when bit-identical)."""
    import torch
    err = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            _fail(f"{name}: output {tuple(a.shape)} {a.dtype} vs plain "
                  f"{tuple(b.shape)} {b.dtype}")
        if not torch.equal(a, b):
            err = max(err, float((a.double() - b.double()).abs().max()))
    if err != 0.0:
        _fail(f"{name}: kernel differs from its plain version "
              f"(max abs err {err})")
    return err


def _kernels(dc, loaded, launches, reads):
    import torch

    from sylph_tpu_torch.gpu import bucket_fill as bf
    from sylph_tpu_torch.gpu import bucket_join as bj
    from sylph_tpu_torch.gpu.grange import (_capr, _cell_ids, _pad_slice,
                                            _repack_step)
    from sylph_tpu_torch.gpu.keys import SENT, key_hi

    eng = dc._grange
    g = eng.gidx
    GE, nt, B, CI = g.g_eff, g.nt, g.B, g.CI
    tile, sub, base = g.tile, g.subwidth, int(g.bases[0])
    TB = bj.block_rows(B)
    ikey, gidg = eng._chunk_dev(0)

    def slice0(name):
        sk, sc = loaded[name][1:3]
        slices, P, CS, density = eng.plan(sk)
        skey, sw = eng.upload_sample(sk, sc)
        pk, pw = _pad_slice(skey, sw, *slices[0], P)
        return pk, pw.to(torch.int32), P, CS, density

    rows = []

    def record(name, src, replaces, err, ms, plain_ms, nbytes, ops,
               library_ms=None, n_launches=None):
        """One kernels-JSON row; the bound is the larger of the bytes the
        call must move over the HBM rate and its int32 operations over the
        INT32 issue rate. Launches are the GTDB-scale path's unless given
        (another path's count)."""
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_INT32_OPS_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source=f"sylph_tpu_torch/csrc/{src}",
            replaces=replaces,
            launches=launches[name] if n_launches is None else n_launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms))
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"bound {max(t_bytes, t_ops):.4f} ms), bit-identical")

    # B1 fill, tiled cells of chunk 0's real slice of sample.sylsp
    pk, pw, P, CS, density = slice0("sample")
    fkw = dict(width=g.width, B=B, CS=CS, nt=nt, subwidth=sub)
    got = bf.bucket_fill(pk, pw, base, **fkw)
    want = bj._sample_to_buckets(pk, pw, base=base, **fkw)
    err = _same("B1_fill", got, want)
    NC = B * nt
    record("B1_fill", "fill.cu", "sylph_tpu/tpu/bucket_fill.py:278", err,
           _cuda_ms(lambda: bf.bucket_fill(pk, pw, base, **fkw), 50),
           _cuda_ms(lambda: bj._sample_to_buckets(pk, pw, base=base, **fkw),
                    5),
           _live_entries(pw) * 12 + NC * CS * 12, 0)
    dk = got[0].view(B, nt * CS)
    dw = got[1].view(B, nt * CS)
    LW = nt * CS

    # B2 compare + codes + column compaction, at the engine's CAPR
    capr = _capr(density, TB)
    jkw = dict(G=GE, nt=nt, tile=tile)
    got = bj.join_codes_compact(ikey, gidg, dk, dw, CAPR=capr, **jkw)
    want = bj.join_codes_compact_plain(ikey, gidg, dk, dw, CAPR=capr, **jkw)
    err = _same("B2_join_codes_compact", got, want)
    record("B2_join_codes_compact", "join.cu",
           "sylph_tpu/tpu/bucket_join.py:290", err,
           _cuda_ms(lambda: bj.join_codes_compact(ikey, gidg, dk, dw,
                                                  CAPR=capr, **jkw), 20),
           _cuda_ms(lambda: bj.join_codes_compact_plain(
               ikey, gidg, dk, dw, CAPR=capr, **jkw), 2),
           B * CI * 12 + B * LW * 12 + B // TB * capr * CI * 4,
           _live_compares(ikey, dw, nt, tile) * INT32_OPS_PER_COMPARE)

    # B3 repack: the first pass over chunk 0's column-major code stream
    stream = got[0].t().contiguous().view(-1)
    row, cap = _repack_step(stream.numel(), density * TB / capr, 4.0)
    got = bf.repack1_flat(stream, row=row, cap=cap)
    want = bf.repack1_flat_plain(stream, row=row, cap=cap)
    err = _same("B3_repack", (got,), (want,))
    shared = {"codes": (stream, row, cap)}
    live = stream != SENT
    record("B3_repack", "repack.cu", "sylph_tpu/tpu/bucket_fill.py:166",
           err, _cuda_ms(lambda: bf.repack1_flat(stream, row=row, cap=cap),
                         50),
           _cuda_ms(lambda: bf.repack1_flat_plain(stream, row=row, cap=cap),
                    5),
           stream.numel() * 4 + got.numel() * 4, 0,
           library_ms=_cuda_ms(lambda: torch.masked_select(stream, live),
                               50))

    # B4 full code grid, on chunk 0's slice of the dense deep.sylsp
    dpk, dpw, _dP, dCS, _dd = slice0("deep")
    dfk, dfw = bf.bucket_fill(dpk, dpw, base, width=g.width, B=B, CS=dCS,
                              nt=nt, subwidth=sub)
    ddk, ddw = dfk.view(B, nt * dCS), dfw.view(B, nt * dCS)
    got = bj.join_codes(ikey, gidg, ddk, ddw, **jkw)
    want = bj.join_codes_plain(ikey, gidg, ddk, ddw, **jkw)
    err = _same("B4_join_codes", (got,), (want,))
    dLW = nt * dCS
    record("B4_join_codes", "join.cu", "sylph_tpu/tpu/bucket_join.py:241",
           err, _cuda_ms(lambda: bj.join_codes(ikey, gidg, ddk, ddw, **jkw),
                         20),
           _cuda_ms(lambda: bj.join_codes_plain(ikey, gidg, ddk, ddw,
                                                **jkw), 2),
           B * CI * 16 + B * dLW * 12,
           _live_compares(ikey, ddw, nt, tile) * INT32_OPS_PER_COMPARE)

    # B5 count grid, as the lossless redo runs it: flat cells at 4x CS
    fk, fw = bf.bucket_fill(pk, pw, base, width=g.width, B=B, CS=4 * CS)
    got = bj.join_counts(ikey, fk, fw)
    want = bj.join_counts_plain(ikey, fk, fw)
    err = _same("B5_join_counts", (got,), (want,))
    record("B5_join_counts", "join.cu", "sylph_tpu/tpu/bucket_join.py:237",
           err, _cuda_ms(lambda: bj.join_counts(ikey, fk, fw), 10),
           _cuda_ms(lambda: bj.join_counts_plain(ikey, fk, fw), 1),
           B * CI * 12 + B * 4 * CS * 12,
           _live_compares(ikey, fw) * INT32_OPS_PER_COMPARE)

    # overflow 1: cells one lane deep drop entries; the engine's weight
    # conservation scalar must see it
    small = dict(fkw, CS=1)
    got = bf.bucket_fill(pk, pw, base, **small)
    _same("B1_fill overflow", got,
          bj._sample_to_buckets(pk, pw, base=base, **small))
    in_range = _cell_ids(key_hi(pk), width=g.width, B=B, base=base)[2]
    w_lost = int(torch.where(in_range, pw, 0).sum() - got[1].sum())
    if w_lost <= 0:
        _fail("CS overflow was not detected (w_lost == 0)")
    # overflow 2: a sample holding every key of chunk 0's first 128
    # buckets makes every slot live, far past CAPR rows per column block
    rk = ikey[:128]
    keys = torch.sort(rk[rk >= 0]).values
    kw = torch.ones_like(keys, dtype=torch.int32)
    occ = int(torch.bincount(_cell_ids(key_hi(keys), width=g.width, B=B,
                                       base=base)[0]).max())
    ocs = -(-occ // 8) * 8
    ok_, ow_ = bf.bucket_fill(keys, kw, base, width=g.width, B=128, CS=ocs)
    got = bj.join_codes_compact(rk, gidg[:128], ok_, ow_, G=GE, CAPR=capr)
    want = bj.join_codes_compact_plain(rk, gidg[:128], ok_, ow_, G=GE,
                                       CAPR=capr)
    _same("B2_join_codes_compact overflow", got, want)
    n_comp = int((got[0] != SENT).sum())
    if int(got[1]) <= n_comp:
        _fail("CAPR overflow was not detected (n_live == n_comp)")
    print(f"overflow checks: CS=1 fill lost weight {w_lost}; CAPR={capr} "
          f"kept {n_comp} of {int(got[1])} live codes")
    shared["keys"] = _seed_kernels(dc.device, reads, record)
    return rows, record, shared


def _batched_kernels(dc, tables, launches, record):
    """(p): B2b, B4b and B5b on chunk 0 of the GTDB-scale index against the
    three cohort samples' slices (S = 3), sized as the batched sweep sizes
    them, bit for bit against their plain versions and, at S = 1, against
    B2, B4 and B5. ``launches`` are the cohort call's. B4b is launched here
    only: the sweep takes it when the column capacity reaches TB (capr >=
    64), which a batch over this index needs a largest sample of about 58M
    k-mers for."""
    import torch

    from sylph_tpu_torch.gpu import bucket_fill as bf
    from sylph_tpu_torch.gpu import bucket_join as bj
    from sylph_tpu_torch.gpu.grange import _capr, _gather_slices

    eng = dc._grange
    g = eng.gidx
    GE, nt, B, CI = g.g_eff, g.nt, g.B, g.CI
    TB = bj.block_rows(B)
    ikey, gidg = eng._chunk_dev(0)
    keys, w, n_live = eng.upload_tables(tables)
    P, CS, density = eng.plan_batched(n_live, keys.shape[1])
    starts, ends = eng.batched_slices(keys, n_live)
    ck, cw = _gather_slices(keys, w.to(torch.int32), starts[:, 0],
                            ends[:, 0], P)
    del keys, w
    fills = [bf.bucket_fill(ck[s], cw[s], int(g.bases[0]), width=g.width,
                            B=B, CS=CS, nt=nt, subwidth=g.subwidth)
             for s in range(len(tables))]
    dk = torch.stack([k.view(B, nt * CS) for k, _ in fills])
    dw = torch.stack([x.view(B, nt * CS) for _, x in fills])
    del fills, ck, cw
    S, _, LW = dk.shape
    capr = _capr(density, TB)
    jkw = dict(G=GE, nt=nt, tile=g.tile)
    grids = B * CI * 8 + S * B * LW * 12         # index keys + cell grids
    ops = sum(_live_compares(ikey, dw[s], nt, g.tile)
              for s in range(S)) * INT32_OPS_PER_COMPARE
    print(f"batched chunk 0: S={S}, P={P}, CS={CS}, LW={LW}, "
          f"density={density:.4f}, capr={capr}")

    def at_one(name, batched, single):
        """The batched kernel at S = 1 against its single-sample kernel."""
        one = batched(dk[:1], dw[:1])
        got = (one[0][0], one[1]) if isinstance(one, tuple) else (one[0],)
        want = single(dk[0], dw[0])
        _same(f"{name} at S = 1", got,
              want if isinstance(want, tuple) else (want,))

    cases = (
        ("B2b_join_codes_compact_batched", "sylph_tpu/tpu/grange.py:958",
         lambda k, x: bj.join_codes_compact_batched(ikey, gidg, k, x,
                                                    CAPR=capr, **jkw),
         lambda k, x: bj.join_codes_compact_batched_plain(
             ikey, gidg, k, x, CAPR=capr, **jkw),
         lambda k, x: bj.join_codes_compact(ikey, gidg, k, x, CAPR=capr,
                                            **jkw),
         grids + B * CI * 4 + S * B // TB * capr * CI * 4),
        ("B4b_join_codes_batched", "sylph_tpu/tpu/grange.py:923",
         lambda k, x: bj.join_codes_batched(ikey, gidg, k, x, **jkw),
         lambda k, x: bj.join_codes_batched_plain(ikey, gidg, k, x, **jkw),
         lambda k, x: bj.join_codes(ikey, gidg, k, x, **jkw),
         grids + B * CI * 4 + S * B * CI * 4),
        ("B5b_join_counts_batched", "sylph_tpu/tpu/grange.py:816",
         lambda k, x: bj.join_counts_batched(ikey, k, x, nt=nt,
                                             tile=g.tile),
         lambda k, x: bj.join_counts_batched_plain(ikey, k, x, nt=nt,
                                                   tile=g.tile),
         lambda k, x: bj.join_counts(ikey, k, x, nt=nt, tile=g.tile),
         grids + S * B * CI * 4))
    for name, replaces, kern, plain, single, nbytes in cases:
        got = kern(dk, dw)
        got = got if isinstance(got, tuple) else (got,)
        want = plain(dk, dw)
        err = _same(name, got, want if isinstance(want, tuple) else (want,))
        at_one(name, kern, single)
        record(name, "join.cu", replaces, err,
               _cuda_ms(lambda: kern(dk, dw), 10),
               _cuda_ms(lambda: plain(dk, dw), 1), nbytes, ops,
               n_launches=launches[name])


def _seed_kernels(device, reads, record):
    """B7 and B8 on one [SEED_BATCH, 256] batch of the real reads (the
    main path's shape for 150-bp reads) against their plain versions.
    Returns the batch's survivor stream and B8's first (row, cap)."""
    import torch

    from sylph_tpu_torch.engine import device_sketch as ds
    from sylph_tpu_torch.gpu import bucket_fill as bf
    from sylph_tpu_torch.gpu import seeding as sd
    from sylph_tpu_torch.io.fastx import parse_block, stream_blocks

    blocks = stream_blocks(reads)
    px = parse_block(next(blocks), reads)
    blocks.close()
    N, L = SEED_BATCH, 256
    if px.n_records < N:
        _fail(f"first block holds {px.n_records} reads, fewer than {N}")
    packed, lens = ds._upload_batch(
        *ds._build_batch(px, L, np.arange(N)), device)
    for c, k, name in ((C, K, "B7_seed"), (5, 21, "B7_seed k=21 c=5")):
        got = sd.seed_packed(packed, lens, c=c, k=k)
        want = sd.seed_packed_plain(packed, lens, c=c, k=k)
        err = _same(name, got, want)
        print(f"{name}: {int(got[1].sum())} of {N * L} windows kept")
        if name == "B7_seed":
            record(name, "seed.cu", "sylph_tpu/tpu/pallas_seeding.py:152",
                   err, _cuda_ms(lambda: sd.seed_packed(packed, lens, c=c,
                                                         k=k), 20),
                   _cuda_ms(lambda: sd.seed_packed_plain(packed, lens, c=c,
                                                         k=k), 3),
                   N * L // 4 + N * 4 + N * L * 9,
                   _live_windows(lens, k) * INT32_OPS_PER_WINDOW)

    # B8: the batch's first condense_stream pass, as the main path runs it
    rows_ = ds._seed_rows(packed, lens, C, K, L)
    stream = rows_.reshape(-1)
    W = L - K + 1
    plan = bf.condense_plan(stream.numel(), (W / C) / rows_.shape[1])
    row, cap = plan[0]
    got = bf.repack2_flat(stream, row=row, cap=cap)
    err = _same("B8_repack2", (got,), (bf.repack2_flat_plain(
        stream, row=row, cap=cap),))
    live = stream != -1
    record("B8_repack2", "repack.cu", "sylph_tpu/tpu/bucket_fill.py:182",
           err, _cuda_ms(lambda: bf.repack2_flat(stream, row=row, cap=cap),
                         50),
           _cuda_ms(lambda: bf.repack2_flat_plain(stream, row=row, cap=cap),
                    5),
           stream.numel() * 8 + got.numel() * 8, 0,
           library_ms=_cuda_ms(lambda: torch.masked_select(stream, live),
                               50))
    print(f"B8 plan for this batch: {plan} (row, cap) passes")
    # overflow: a window capacity below its live count drops survivors;
    # the caller's count check (live out vs per-read counts) must see it
    n_live = int(live.sum())
    small = bf.repack2_flat(stream, row=16384, cap=256)
    _same("B8_repack2 overflow", (small,), (bf.repack2_flat_plain(
        stream, row=16384, cap=256),))
    kept = int((small != -1).sum())
    if kept >= n_live:
        _fail("B8 overflow was not detected (live count unchanged)")
    print(f"overflow check: B8 at cap 256 of 16384 kept {kept} of "
          f"{n_live} survivors; the count check sees the loss")
    return stream, row, cap


# ---- (t)-(v): the row repacks, kbench and the grange layout cache ---------

def _row_repack_phase(shared, record):
    """(t): B11 and B12 at the shapes of their JAX roles, each driven once
    with the launch counts set to 0 just before and read just after: B11
    condenses the survivor stream of one [65,536, 256] batch of the real
    reads at B8's first (row, cap) (repack_pallas's role: the pair stream
    of read seeding), B12 chunk 0's column-major code stream at B3's (row,
    cap) (repack1_pallas's: the grange code chain). Then each against its
    plain version there, at a geometry only their 128-lane check admits
    (row + 128, cap + 128), and B11 at cap 128, an overflow the caller's
    count must see. B8's first (row, cap) is sized from the random
    expectation (3.4% live) and these reads carry a planted k-mer each
    (4.8%), so B11 drops survivors there too, as B8 does on the main path
    before its caller redoes the batch."""
    import torch

    from sylph_tpu_torch.gpu import _cuda
    from sylph_tpu_torch.gpu import seeding as sd

    keys, krow, kcap = shared["keys"]
    codes, crow, ccap = shared["codes"]
    _cuda.reset_launches()
    b11 = sd.repack_rows(keys, row=krow, cap=kcap)
    b12 = sd.repack1_rows(codes, row=crow, cap=ccap)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    for name in ("B11_repack_rows", "B12_repack1_rows"):
        if launches[name] <= 0:
            _fail(f"{name} was not launched in (t)")
    for name, fn, plain, x, row, cap, width, out in (
            ("B11_repack_rows", sd.repack_rows, sd.repack_rows_plain, keys,
             krow, kcap, 8, b11),
            ("B12_repack1_rows", sd.repack1_rows, sd.repack1_rows_plain,
             codes, crow, ccap, 4, b12)):
        n_live = int((x != -1).sum())
        kept = int((out != -1).sum())
        err = _same(name, (out,), (plain(x, row=row, cap=cap),))
        wide = (row + 128, cap + 128)         # 128-multiples, not 256
        _same(f"{name} at {wide}", (fn(x, row=wide[0], cap=wide[1]),),
              (plain(x, row=wide[0], cap=wide[1]),))
        live = x != -1
        record(name, "repack.cu", {
            "B11_repack_rows": "sylph_tpu/tpu/pallas_seeding.py:314",
            "B12_repack1_rows": "sylph_tpu/tpu/pallas_seeding.py:346"}[name],
            err, _cuda_ms(lambda: fn(x, row=row, cap=cap), 50),
            _cuda_ms(lambda: plain(x, row=row, cap=cap), 5),
            x.numel() * width + out.numel() * width, 0,
            library_ms=_cuda_ms(lambda: torch.masked_select(x, live), 50),
            n_launches=launches[name])
        print(f"{name}: ({row}, {cap}) -> {tuple(out.shape)}, kept {kept} "
              f"of {n_live} live; {wide} bit-identical too")
    _dispatch_split(keys, krow, kcap)
    small = sd.repack_rows(keys, row=krow, cap=128)
    _same("B11_repack_rows overflow", (small,),
          (sd.repack_rows_plain(keys, row=krow, cap=128),))
    kept, n_live = int((small != -1).sum()), int((keys != -1).sum())
    if kept >= n_live:
        _fail("B11 overflow was not detected (live count unchanged)")
    print(f"check (t): B11 and B12 launched and bit-identical; B11 at cap "
          f"128 of {krow} kept {kept} of {n_live} survivors, the loss seen")


def _dispatch_split(keys, row, cap):
    """B8 and B11 are one kernel on one stream at one (row, cap) (72 and 66
    blocks): their CUDA-event times in turns (B8, B11, B11, B8), beside the
    host's enqueue time a call and the device time a launch from
    torch.profiler ("not measured" where it shows none). Where the enqueue
    time reaches the event time, the event time of back-to-back calls is
    the host's, not the kernel's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sylph_tpu_torch.gpu import bucket_fill as bf
    from sylph_tpu_torch.gpu import seeding as sd

    fns = {"B8": lambda: bf.repack2_flat(keys, row=row, cap=cap),
           "B11": lambda: sd.repack_rows(keys, row=row, cap=cap)}
    out = {k: {"event_ms": []} for k in fns}
    for k in ("B8", "B11", "B11", "B8"):
        out[k]["event_ms"].append(_cuda_ms(fns[k], 50))
    for k, fn in fns.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        out[k]["enqueue_ms"] = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if "repack_kernel" in e.key]
        total = sum(getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0)) for e in dev)
        n = sum(e.count for e in dev)
        out[k]["device_ms"] = total / n / 1e3 if total and n else \
            "not measured"
    print("B8 and B11 dispatch split: " + json.dumps(out))


def _kbench_phase(record):
    """(u): sylph_tpu_torch.kbench's table in-process, the launch counts
    set to 0 just before it and read just after; every microkernel was
    held bit for bit against its plain version inside (a mismatch
    raises). The table goes out as one JSON line; each microkernel also
    gets a kernels row."""
    from sylph_tpu_torch import kbench
    from sylph_tpu_torch.gpu import _cuda

    _cuda.reset_launches()
    try:
        rows = kbench.table()
    except RuntimeError as e:
        _fail(f"(u) {e}")
    launches = dict(_cuda.LAUNCHES)
    for r in rows:
        print("kbench " + kbench.format_row(r))
    print(json.dumps({"kbench": rows}))
    for r in rows:
        if r["kernel"] is None:
            continue
        if launches[r["kernel"]] <= 0:
            _fail(f"{r['name']} was not launched in (u)")
        record(r["name"], "kbench.cu", r["replaces"], 0.0, r["ms"],
               r["plain_ms"], r["nbytes"], r["ops"],
               library_ms=r["library_ms"], n_launches=launches[r["kernel"]])
    print(f"check (u): {sum(r['kernel'] is not None for r in rows)} "
          "microkernels and the real kernels bit-identical to their plain "
          "versions")


def _cache_phase(work, bucket_paths):
    """(v): the grange layout cache on the bucket phase's database and
    bsample.sylsp, with the grange regime forced (GRANGE_MIN lowered for
    the phase): the first ``profile`` with SYLPH_GRANGE_CACHE builds the
    layout and saves it, the second loads it. Both TSVs equal (l)'s; the
    loaded layout equals the built one field by field."""
    import torch

    from sylph_tpu_torch.engine.device_exec import DeviceContainment
    from sylph_tpu_torch.gpu.grange import GRangeIndex

    db, spath, tsv_l = bucket_paths
    old = DeviceContainment.GRANGE_MIN
    DeviceContainment.GRANGE_MIN = 0
    os.environ["SYLPH_GRANGE_CACHE"] = os.path.join(work, "grange_cache")
    try:
        runs = []
        for tag in ("save", "load"):
            out = os.path.join(work, f"cache_{tag}.tsv")
            launches, wall, stages, dc = _drive(
                ["profile", db, spath, "-o", out])
            if dc._grange is None:
                _fail("(v) the profile did not run the grange regime")
            if launches["B1_fill"] <= 0:
                _fail("(v) the grange sweep launched no B1")
            runs.append((out, wall, stages.split(), dc._grange.gidx))
            del dc
    finally:
        DeviceContainment.GRANGE_MIN = old
        del os.environ["SYLPH_GRANGE_CACHE"]
    with open(tsv_l) as f:
        want = f.read()
    for out, *_ in runs:
        with open(out) as f:
            if f.read() != want:
                _fail(f"(v) {os.path.basename(out)} differs from (l)'s TSV")
    (_, wall_s, st_s, built), (_, wall_l, st_l, loaded) = runs
    for name in GRangeIndex._fields:
        x, y = getattr(built, name), getattr(loaded, name)
        same = (all(torch.equal(u, v) and u.dtype == v.dtype
                    for u, v in zip(x, y)) and len(x) == len(y)
                if isinstance(x, list) else
                x.dtype == y.dtype and np.array_equal(x, y)
                if isinstance(x, np.ndarray) else x == y)
        if not same:
            _fail(f"(v) the loaded layout's {name} differs from the built")
    build = sum(v for k, v in st_s.items() if k.startswith("grange index "
                                                            "build"))
    split = dict(save_call_wall_s=wall_s, build_s=build,
                 save_s=st_s.get("grange cache save", 0.0),
                 load_call_wall_s=wall_l,
                 load_s=st_l.get("grange cache load", 0.0),
                 load_call_build_s=sum(
                     v for k, v in st_l.items()
                     if k.startswith("grange index build")))
    if not (split["build_s"] > 0 and split["save_s"] > 0
            and split["load_s"] > 0 and split["load_call_build_s"] == 0):
        _fail(f"(v) stage split shows no build/save/load: {split}")
    print("grange cache: " + json.dumps(split))
    print("check (v): both TSVs equal (l)'s; the loaded layout equals the "
          "built one field by field")


def main(argv=None) -> int:
    a = _parse(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from sylph_tpu_torch.gpu import _cuda

    smi = _smi()
    print(smi)
    t0 = time.perf_counter()
    _cuda.build_all()
    print("build: " + json.dumps(dict(
        wall_s=time.perf_counter() - t0, per_source_s=_cuda.BUILD_SECONDS)))
    for name, text in _cuda.BUILD_LOG.items():
        print(f"--- nvcc {name}\n{text}", file=sys.stderr)
    reduced = {}
    if a.kmers_per_genome != KMERS_PER_GENOME:
        reduced.update(kmers_per_genome=[KMERS_PER_GENOME,
                                         a.kmers_per_genome],
                       index_kmers=GENOMES * a.kmers_per_genome)
    if reduced:
        print("reduced: " + json.dumps(reduced))

    # generated data (about 9 GB), removed at the end
    work = os.path.abspath(os.path.join("build", "chip_smoke"))
    os.makedirs(work, exist_ok=True)
    try:
        t0 = time.perf_counter()
        db, samples, kmers, picks = _make_world(a, work)
        print(f"generate: {time.perf_counter() - t0:.3f} s "
              f"({GENOMES} genomes x {a.kmers_per_genome} k-mers)")
        t0 = time.perf_counter()
        reads, abundant, n_bases, read_codes = _make_reads(a, work, kmers,
                                                           picks)
        del kmers
        print(f"generate reads: {time.perf_counter() - t0:.3f} s "
              f"({n_bases} bases, {os.path.getsize(reads)} bytes bgzf)")
        host_path = _host_sketch(reads, work)
        dc, tsv, launches, card, per, ingest = _main_path(
            db, reads, [p for p, _ in samples.values()] + [host_path], work)
        g = dc._grange.gidx
        print(f"index: {len(g.chunk_keys)} chunks of [{g.B}, {g.CI}], "
              f"nt={g.nt}, {g.spill_kmers.size} spilled, "
              f"{g.n_heavy} heavy runs")
        loaded = _check_outputs(dc, samples, tsv)
        host_tbl = _check_reads(dc, reads, card, host_path, abundant, tsv,
                                per, ingest)
        cohort = {samples[n][0]: loaded[n][3] for n in ("sample", "deep")}
        cohort[host_path] = host_tbl[2]
        c_launches = _cohort_phase(dc, db, cohort, tsv, per)
        batch, blens, q_launches, s_launches = _profile_phase(a, dc.device)
        _gtdb_pipeline_phase(dc, read_codes)
        del read_codes
        small_db, asm_paths, sk_launches = _sketch_phase(a, work)
        genomes, small = _merge_phase(a, work, small_db)
        _merge_cohort_phase(a, work, small_db, genomes, small)
        bdc, bsmp, b_launches, bucket_paths = _bucket_phase(a, work)
        rows, record, shared = _kernels(dc, loaded, launches, reads)
        _batched_kernels(dc, [loaded["sample"][1:3], loaded["deep"][1:3],
                              host_tbl[:2]], c_launches, record)
        _small_db_kernels(bdc, bsmp, asm_paths, b_launches, sk_launches,
                          record)
        _pipeline_kernels(dc.device, batch, blens, q_launches, s_launches,
                          record)
        for tag, phase in (
                ("t", lambda: _row_repack_phase(shared, record)),
                ("u", lambda: _kbench_phase(record)),
                ("v", lambda: _cache_phase(work, bucket_paths))):
            t0 = time.perf_counter()
            phase()
            print(f"phase ({tag}): {time.perf_counter() - t0:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
