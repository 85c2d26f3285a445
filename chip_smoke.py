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
     time, its plain version's, its bound and, for B3, B8, B11 and B12,
     one library call's (torch.masked_select). The rows of csrc/join.cu
     (B2, B4, B5, B5', B2b, B4b, B5b), csrc/seed.cu (B7 on reads and on
     genome rows), csrc/fill.cu (B1 on the grange slices of sample.sylsp
     and deep.sylsp and on the whole range) and csrc/repack.cu (B3, B8,
     B11, B12) also carry torch.profiler's device time a launch (a time
     under about 0.05 ms by CUDA events is mostly the host's) and the
     launch's occupancy as the card reports it (registers, shared memory,
     resident CTAs a SM; B1 also its cells a block, the repacks their
     cluster, piece and resident clusters); the repack rows also carry
     the profiler's time of all the library call's device work
     (``library_profiler_ms``); B3's and B8's (row, cap, nwin) are
     printed; a line of its own
     beside each join row gives the compares the kernel issues (per warp,
     from its loop bounds) and those the data needs, both computed from
     the inputs, not measured.

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

  8. The serving surface and c = 1, after the main path's engines are
     freed, each phase timed: (w) ``runner.serve`` in-process on the main
     path's db.syldb, cold (its own load, index build and upload, printed),
     answering a request stream: sample.sylsp, reads.fastq.gz (raw,
     streamed to the card: B7, B8), deep.sylsp, reads_host.sylsp, a
     missing path, a three-token line and sample.sylsp again. Every good
     request's rows equal its sample's rows in (g)'s TSV byte for byte,
     the repeat's the first's; B1, the compare (B2, or B4 on deep.sylsp's
     dense slices) and B3 launch on each good request (counts set to 0
     before each line); torch.cuda.memory_allocated() after each request,
     and after the repeat at most the first's plus the device bytes the
     engine's per-sample caches and its captured stream sweeps' static
     buffers hold; each request's wall time and stage
     split; the repeat runs inside a torch.profiler window, whose kernels
     and copies give the device's busy and idle share of its wall time.
     (x) On (j)'s merge database: ``api.Profiler(db)`` on the card,
     ``.profile(s)`` twice and ``.query(s)`` give (j)'s and (k)'s .syldb
     query rows in every column a ProfileRow holds, from one engine; two
     ``contain`` calls under SYLPH_TPU_CACHE_INDEX=1 construct one
     DeviceContainment; ``profile --profile-trace DIR`` writes a Chrome
     trace holding the merge join's kernels. (y) c = 1: the 72 smallest of
     (i)'s assemblies sketched with ``sketch -c 1 -g`` (about 9M k-mers,
     half of them 2^63 or more; 64 genomes or more, so the grange regime's
     device prefilter sweeps the chunks) and a sample planting 8 of them at
     c = 1, profiled in the merge,
     bucket and grange regimes (BUCKET_MIN or GRANGE_MIN lowered for the
     call): the three TSVs equal and list exactly the planted genomes; the
     grange histograms equal the oracle; B1 on the grange chunk slice,
     sorted in uint64 order with keys of 2^63 and up, equals its plain
     version.

  9. Several devices and processes, on the one card (right after (3) the
     main engine's layout is saved once with SYLPH_GRANGE_CACHE's writer:
     its seconds and bytes). They prove placement, ownership, collectives
     and merging exact with the real kernels, nothing about scaling.
     (z) One process, two logical devices: the layout loaded from that
     cache into a GRangeEngine on [cuda:0, cuda:0]; sample.sylsp's and
     deep.sylsp's histograms equal (a)'s oracle and a one-device engine's
     (each sweep timed beside that one's), B1 and B2 (B4 on deep)
     launch once a chunk; then (j)'s and (o)'s calls with
     DeviceContainment on [cuda:0, cuda:0]: the sharded merge join, TSVs
     byte for byte, (o)'s four samples in one batched sharded join.
     (aa) Two processes: ``profile db.syldb sample.sylsp deep.sylsp
     --coordinator 127.0.0.1:PORT --num-processes 2 --process-id i`` with
     SYLPH_GRANGE_CACHE set, through cli.main in ``python -m
     sylph_tpu_torch.multichip worker cli``; process 0's rows equal the
     main call's for both samples, process 1 writes nothing, each process
     launches B1 and B2/B4 on exactly its chunks; each process's wall,
     stage split (its GTDB-scale cache load among them) and device memory.
     (ab) make_sharded_profile_step on (q)'s data: two gloo ranks sharing
     the card (dp = 2, each half of every batch's reads and half the
     index), then one NCCL rank; every rank's histogram equals (q)'s, its
     statistics (q)'s within rtol 1e-5, and B6 and B8 launch in every rank.

 10. (ac) The port's bench (``sylph_tpu_torch/bench.py``) through its own
     functions, each config with the launch counts set to 0 just before it
     and BENCH_REPS timed runs: ``gtdb`` at full width (its index made on
     the card by gpu/synth_index.py, 100,000 genomes x 7,168 k-mers in 22
     chunks of [32768, 1152]; chunk 0 and the last equal to the host
     replay and the live slots to m; 64 batches of [65,536, 256] planted
     reads; the last timed run's histogram equal to a searchsorted oracle
     of its folded sample against every live index key, every run's probe
     exact); ``gtdb --dup`` (the markers' expansion ok in every run);
     ``gtdb --samples 4`` (each batched row equal to the sample's own
     sweep); ``profile``, ``sketch``, ``multisample``; ``entry()`` (its
     histogram equal to its plain run on the CPU, statistics within rtol
     1e-5); ``gtdb_cli`` on (3)'s db.syldb and reads.fastq.gz from (3)'s
     saved layout, and ``sketchdb`` on (i)'s assemblies (cuts listed under
     ``reduced``; ``e2e`` is not run). Each config's JSON line is printed
     with its stage split and launches.

 11. (ad) The host engine and the dev tools, each with the launch counts
     set to 0 just before it: ``profile`` and ``query --device host`` of
     (j)'s merge database and ``profile --device host`` of (l)'s bucket
     database (the native C seeder and host probes: no kernel launches)
     give the card's TSVs of the same calls byte for byte (the grange
     database and the bucket query are cut: ``reduced``);
     ``sylph_tpu_torch.gbench`` at full width (the gtdb config's 100,000 x
     7,168 index made on the card, 64 batches of [65,536, 256] planted
     reads; variants prefix joinonly joinstages dense75 seed_t fused8; 2
     timed reps; device times of joinstages' lines only): every variant's
     histogram equals full's, full's the oracle, B5 launches once a chunk
     in joinstages' +compare line (its launches and profiler ms join the
     kernels line's B5 row);
     ``sylph_tpu_torch.dupskew`` at a reduced size (listed under
     ``reduced``), its four default profiles at nt 1 and 4, every parity
     and dparity OK; ``sylph_tpu_torch.stage_timing`` (plain seeding, B7
     and the compaction agree at [65,536, 256]); and
     ``sylph_tpu_torch.profile_ingest`` on 2 blocks of (3)'s
     reads.fastq.gz (its phased sketch equals the host seeder's). Each
     tool prints its record as one ``(ad) NAME: {json}`` line.

Any failed check raises and the script exits non-zero. The last lines are
the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import argparse
import gc
import json
import logging
import os
import shutil
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
# SM clocks a second: 132 SMs at the 1.98 GHz boost (Hopper whitepaper);
# the data sheet has no integer rate outside the tensor cores
H100_SM_CLOCKS_PER_S = 132 * 1.98e9


def _sm_clocks(alu=0.0, fma=0.0, either=0.0, quarter=0.0, other=0.0):
    """The least SM clocks that issue this many 32-bit lane-instructions,
    each counted by the pipe that must run it. A Hopper SM dispatches 4
    warp instructions (128 lanes) a clock (whitepaper: 32 threads a clock
    a partition); its ALU pipe (SHF, LOP3, ISETP, SEL) and its FMA pipe
    (IMAD) each take 64 lanes a clock; ``either`` is work that either pipe
    can do (an add or a shift-and-add: IADD3 or LEA on the ALU pipe, IMAD
    on the FMA pipe); ``quarter`` (POPC, BREV) runs at 16 a clock (CUDA C
    programming guide, throughput of arithmetic instructions, 9.0);
    ``other`` (SHFL, VOTE) only takes issue slots."""
    return max(alu / 64, fma / 64, quarter / 16,
               (alu + fma + either + quarter + other) / 128)


# a 64-bit equality and its conditional add in join.cu's lane loop: two
# ISETP (low word, then high word chained) and one predicated add
COMPARE_CLOCKS = _sm_clocks(alu=2, either=1)
# a k-mer window of seed.cu or seed_pack.cu (B6, B7, B9, B10), counted in
# the cheapest form of common.cuh's pair code (k >= 17: two adjacent
# windows a lane, the second's forward k-mer rolled from the first's),
# per window:
#   ALU 29: the bases (2 funnel shifts); the forward k-mer's pair swap and
#     shift down (2 SHF, 1 LOP3: half of a pair's); the rolled window's
#     base and high word (1 SHF, 1 LOP3); the reverse complement (2 LOP3);
#     the canonical min (2 ISETP, 2 SEL); the mix's three 64-bit
#     xor-shifts (6 SHF, 6 LOP3, the NOT folded in); the threshold and
#     length tests (3 ISETP); the rank's lane masks (1 LOP3);
#   FMA 8: the mix's four 64-bit multiplies by constants (an IMAD.WIDE.U32
#     and an IMAD each);
#   either 4: the pair swap's left shift (1), the rolled window's low word
#     (0.5), the rank's adds (2.5);
#   quarter 2: a pair's 2 BREV and 2 POPC (the compiled kernels' count);
#   other 2.5: a pair's 3 SHFL and 2 VOTE.
# The ALU pipe binds: 29 / 64 = 0.453 clocks a window (all 45.5 issue in
# 0.355). The compiled kernels issue more (kernel_ab prints their SASS).
WINDOW_CLOCKS = _sm_clocks(alu=29, fma=8, either=4, quarter=2, other=2.5)
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
    kmers = [getattr(g, "genome_kmers", g) for g in genomes]

    def blocks(step=8192):
        for g0 in range(0, len(kmers), step):
            blk = kmers[g0:g0 + step]
            k = torch.from_numpy(np.concatenate(blk).view(np.int64)).to(
                device)
            sizes = torch.tensor([a.size for a in blk], device=device)
            yield k, torch.repeat_interleave(
                torch.arange(g0, g0 + len(blk), device=device), sizes)
    return _oracle_blocks(blocks(), sk, sc, len(genomes), device, H)


def _oracle_blocks(blocks, sk, sc, G, device, H=64):
    """[G, H] exact histograms of (index keys, genome ids) blocks (int64
    bit patterns of the uint64 hashes, on ``device``) against the sorted
    sample (uint64 ``sk``, counts ``sc``): a searchsorted a block, both
    sides in uint64 order (the bits xor 2^63: at c = 1 a hash can be 2^63
    or more)."""
    import torch
    flip = np.uint64(1 << 63)
    skd = torch.from_numpy((sk ^ flip).view(np.int64)).to(device)
    scd = torch.from_numpy(sc.astype(np.int64)).to(device)
    n = skd.numel()
    hist = torch.zeros(G * H, dtype=torch.int64, device=device)
    for k, gid in blocks:
        k = k ^ -(1 << 63)
        idx = torch.searchsorted(skd, k)
        idxc = idx.clamp(max=max(n - 1, 0))
        cnt = torch.where((idx < n) & (skd[idxc] == k), scd[idxc], 0)
        live = cnt > 0
        hist += torch.bincount(gid[live].to(torch.int64) * H
                               + cnt[live].clamp(max=H - 1),
                               minlength=G * H)
        del k, idx, idxc, cnt, live
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


def _same_sketch(a, b) -> bool:
    """Two sketches with equal k-mers in order, counts and mean read
    length."""
    return bool(np.array_equal(a.kmers, b.kmers)
                and np.array_equal(a.counts, b.counts)
                and a.mean_read_length == b.mean_read_length)


def _sketch_diff(card, host):
    """Where two sketches of one read set differ: sizes, counted k-mers,
    mean read lengths and the k-mers only one of them holds."""
    only_card = np.setdiff1d(card.kmers, host.kmers)
    only_host = np.setdiff1d(host.kmers, card.kmers)
    return dict(kmers=[int(card.kmers.size), int(host.kmers.size)],
                counted=[int(card.counts.sum()), int(host.counts.sum())],
                mean_read_length=[float(card.mean_read_length),
                                  float(host.mean_read_length)],
                only_card=int(only_card.size), only_host=int(only_host.size),
                first_only_card=[int(x) for x in only_card[:4]],
                first_only_host=[int(x) for x in only_host[:4]])


def _check_reads(dc, reads, card, host_path, abundant, tsv, per, ingest):
    """Checks (d)-(g) of the raw-read sample, and its stage split. Returns
    reads_host.sylsp's (sorted kmers, counts, oracle histogram)."""
    import torch

    from sylph_tpu_torch.core.sketch_reads import sketch_sequences
    from sylph_tpu_torch.io import sylformat

    host = sylformat.read_sylsp(host_path)
    if not _same_sketch(card, host):
        # the read set sketched once more on each side says which side
        # gave the odd sketch, and whether it does so again
        card2 = sketch_sequences(reads, C, K, "card2", device=dc.device)
        host2 = sketch_sequences(reads, C, K, "host2", device=None)
        _fail("(d) the card's sketch of the reads differs from the host "
              "seeder's: " + json.dumps(dict(
                  _sketch_diff(card, host),
                  card_again_equals=dict(card=_same_sketch(card2, card),
                                         host=_same_sketch(card2, host)),
                  host_again_equals=dict(card=_same_sketch(host2, card),
                                         host=_same_sketch(host2, host)))))
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
    return genomes, (spath, planted, picks), (tsv, qa)


def _merge_cohort_phase(a, work, db, genomes, small):
    """(o): ``profile small.syldb`` of small.sylsp and three more planted
    samples (distinct planted sets) at the default merge depth of 8: one
    batched merge join, its counts equal to per-sample joins, and each
    sample's TSV rows list exactly its planted genomes. Returns (the
    samples' paths, the TSV's path)."""
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
    return paths, tsv


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
           n_launches=launches["B1_fill"],
           **_fill_extras(lambda: bf.bucket_fill(skey, sw, 0, **fkw),
                          skey.shape[0], B, CS))
    dk, dw = got
    ikey = ch.key
    got = bj.bucket_counts(ikey, dk, dw)
    err = _same("B5p_bucket_join", (got,),
                (bj.join_counts_plain(ikey, dk, dw),))
    live = int((dw > 0).sum())
    print(f"B5' at chunk 0: [{B}, {CI}] x {CS} lanes, {live} of {B * CS} "
          f"lanes live ({1 - live / (B * CS):.3f} pad share)")
    def b5p():
        return bj.bucket_counts(ikey, dk, dw)

    record("B5p_bucket_join", "join.cu", "sylph_tpu/tpu/bucket_join.py:377",
           err, _cuda_ms(b5p, 20),
           _cuda_ms(lambda: bj.join_counts_plain(ikey, dk, dw), 2),
           _join_bytes(ikey, dw, B * CI * 4),
           _live_compares(ikey, dw) * COMPARE_CLOCKS,
           n_launches=launches["B5p_bucket_join"],
           profiler_ms=_profiler_ms(b5p, "join_kernel"),
           **_join_extras("B5p_bucket_join", bj._MODE_COUNTS, ikey,
                          dk[None], dw[None]))

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
           _live_windows(lens, K) * WINDOW_CLOCKS,
           n_launches=sk_launches["B7_seed"],
           **_seed_extras(lambda: sd.seed_packed(packed, lens, c=C, k=K)))


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


def _profile_phase(a, dev, work):
    """(q) bench.py's profile config on the card through the one-shot
    pipeline, and (s) the same batches under SYLPH_SEED_T=1 (B9). (q)'s
    batches and index are written under ``work``/step for (ab). Returns
    (one batch, its lengths, (q)'s launches, (s)'s launches, (ab)'s data
    directory, (q)'s histogram and statistics on the host)."""
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
    from sylph_tpu_torch.multichip import save_step_data
    step_dir = os.path.join(work, "step")
    save_step_data(step_dir, torch.stack(batches).cpu().numpy(),
                   torch.stack(lens).cpu().numpy(), idx.keys,
                   idx.genome_ids, idx.n_kmers, c=C, **kw)
    q_ref = (hist.cpu().numpy(), type(st)(*[f.cpu() for f in st]))

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
    print("A5b, sketch stage of the same 64 batches: " + json.dumps(dict(
        q_b6_ms=stages["sketch_s"] * 1e3,
        s_transpose_and_b9_ms=s_stages["sketch_s"] * 1e3)))
    return batches[0], lens[0], q_launches, s_launches, step_dir, q_ref


def _gtdb_pipeline_phase(dc, codes):
    """(r): bench.py's gtdb shape on the main path's grange engine: the
    main path's 7,158,278 reads packed into [65,536, 256] batches (lengths
    150, the last batch padded with length-0 rows), sketch_batch (B6) per
    batch, condense_stream (B8), the occurrence-stream hist_device_stream
    (folded on the card) and the statistics. Returns (the first batch, its
    lengths, the launches)."""
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
    return batches[0], lens[0], launches


def _pipeline_kernels(dev, batch, lens, q_launches, s_launches, r_batch,
                      record):
    """B6, B9 and B10 on one [65,536, 256] batch of (q) against their plain
    versions, B6 on one of (r)'s batches (150-base reads in 256-base
    rows), plus an overflow case (L = 512, c = 2: more than 128 survivors
    a read) and B10 at k = 15."""
    import torch

    from sylph_tpu_torch.gpu import seed_pack as sp

    N, L = batch.shape
    clocks = _live_windows(lens, K) * WINDOW_CLOCKS
    io = N * L + N * 4
    bt = batch.t().contiguous()
    cap_t = sp.cap_rows_t(L, C)
    rb, rl, r_launches = r_batch
    cases = (
        ("B6_seed_pack", ":283", q_launches["B6_seed_pack"], N * PIPE_CAP,
         lambda: sp.seed_pack(batch, lens, c=C, k=K, lanes=PIPE_CAP),
         lambda: sp.seed_pack_plain(batch, lens, c=C, k=K, lanes=PIPE_CAP),
         "rows", clocks),
        ("B6_seed_pack (128 lanes)", ":283", 0, N * 128,
         lambda: sp.seed_pack(batch, lens, c=C, k=K),
         lambda: sp.seed_pack_plain(batch, lens, c=C, k=K), "rows", clocks),
        ("B6_seed_pack (gtdb reads)", ":283", r_launches["B6_seed_pack"],
         N * PIPE_CAP,
         lambda: sp.seed_pack(rb, rl, c=C, k=K, lanes=PIPE_CAP),
         lambda: sp.seed_pack_plain(rb, rl, c=C, k=K, lanes=PIPE_CAP),
         "rows", _live_windows(rl, K) * WINDOW_CLOCKS),
        ("B9_seed_pack_t", ":501", s_launches["B9_seed_pack_t"], N * cap_t,
         lambda: sp.seed_pack_t(bt, lens, c=C, k=K),
         lambda: sp.seed_pack_t_plain(bt, lens, c=C, k=K), "cols", clocks),
        ("B10_seed_compact", ":183", 0, N * 128,
         lambda: sp.seed_compact(batch, lens, c=C, k=K),
         lambda: sp.seed_compact_plain(batch, lens, c=C, k=K), "rows", clocks))
    for name, line, n_launch, out_slots, kern, plain, kind, n_clocks in cases:
        err = _same(name, (kern(),), (plain(),))
        record(name, "seed_pack.cu", "sylph_tpu/tpu/pallas_seeding.py"
               + line, err, _cuda_ms(kern, 20), _cuda_ms(plain, 3),
               io + out_slots * 8, n_clocks, n_launches=n_launch,
               **_seed_pack_extras(kern, kind))
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


def _executed_compares(ikey, dk, dw, nt: int = 1, tile: int = 0):
    """Compares join.cu issues for one sample's [B, LW] cells, computed
    from the shapes and the kernel's loop bounds (not measured), counted
    per warp: where any thread of a warp compares a row, all 32 threads
    issue the loop over the row's live lanes (each list padded to even) for
    their two columns, 64 compares a lane. A warp's 64 columns see one lane
    group (tile a multiple of 64), or past the tiles every live lane: one
    merged list where its CTA's 128 columns all lie past the tiles, else
    every group's list. A column compares a row unless its slot holds the
    pad key and no live lane its CTA staged holds it. None where a warp's
    columns could see two groups."""
    nt = max(nt, 1)
    if nt > 1 and tile % 64:
        return None
    B, CI = ikey.shape
    tiled = nt * tile if nt > 1 else 0
    live = dw != 0
    per_g = live.view(B, nt, -1).sum(2)                    # [B, nt]
    neg_g = (live & (dk == -1)).view(B, nt, -1).any(2)
    total = 0
    for j0 in range(0, CI, 64):
        c0 = j0 // 128 * 128
        cl = min(c0 + 128, CI) - 1
        if c0 >= tiled:
            n = per_g.sum(1) + per_g.sum(1) % 2
        elif j0 >= tiled:
            n = (per_g + per_g % 2).sum(1)
        else:
            n = per_g[:, j0 // tile] + per_g[:, j0 // tile] % 2
        staged = (neg_g if cl >= tiled
                  else neg_g[:, c0 // tile:cl // tile + 1])
        go = (ikey[:, j0:j0 + 64] != -1).any(1) | staged.any(1)
        total += int((go * n).sum()) * 64
    return total


def _join_bytes(ikey, dw, out_bytes: int, counts=None) -> int:
    """Bytes a join.cu launch must move: the key grid once, the weight
    grid(s), 8 B for each live lane's key, 4 B of gid for each slot whose
    count is > 0 (code modes: ``counts`` given) and the output as
    written."""
    n = ikey.numel() * 8 + dw.numel() * 4 + int((dw != 0).sum()) * 8
    if counts is not None:
        n += int((counts > 0).sum()) * 4
    return n + out_bytes


def _join_extras(name, mode, ikey, dk, dw, nt: int = 1,
                 tile: int = 0) -> dict:
    """A join.cu row's occupancy as the card reports it for this launch,
    for [S, B, LW] cells. Prints, on a line of its own, the compares the
    kernel issues beside those the data needs, both computed from this
    run's inputs (``_executed_compares``, ``_live_compares``), not
    measured."""
    from sylph_tpu_torch.gpu import bucket_join as bj
    S, _, LW = dk.shape
    ex = [_executed_compares(ikey, dk[s], dw[s], nt, tile) for s in range(S)]
    print(f"{name} compares, computed from the inputs and join.cu's loop "
          "bounds, per warp (not measured): " + json.dumps(dict(
              executed=None if None in ex else sum(ex),
              needed=sum(_live_compares(ikey, dw[s], nt, tile)
                         for s in range(S)))))
    plan = bj.join_plan(S, ikey.shape[1], LW, nt, tile, mode)
    return dict(occupancy=bj.join_occupancy(mode, plan))


def _profiler_ms(fn, kernel: str, reps: int = 20):
    """Device ms a launch of the kernel whose name holds ``kernel``, by
    torch.profiler over ``reps`` calls of one launch each ("not measured"
    where it shows no device time or captured another number of
    launches)."""
    from sylph_tpu_torch.gpu._cuda import device_ms
    ms = device_ms(fn, kernel, reps)
    return "not measured" if ms is None else ms


def _seed_extras(fn) -> dict:
    """A B7 row's torch.profiler device time and the card's occupancy
    readout for csrc/seed.cu."""
    from sylph_tpu_torch.gpu import seeding as sd
    return dict(profiler_ms=_profiler_ms(fn, "seed_kernel"),
                occupancy=sd.seed_occupancy())


def _seed_pack_extras(fn, kind: str) -> dict:
    """A csrc/seed_pack.cu row's (B6, B9, B10) torch.profiler device time
    and the card's occupancy readout for its kernel (``kind``: the row
    kernel "rows" or the column kernel "cols")."""
    from sylph_tpu_torch.gpu import seed_pack as sp
    return dict(profiler_ms=_profiler_ms(fn, f"seed_pack_{kind}"),
                occupancy=sp.seed_pack_occupancy(kind))


def _fill_extras(fn, P: int, NC: int, CS: int) -> dict:
    """A B1 row's torch.profiler device time, and the card's occupancy
    readout and cells a block of its launch plan."""
    from sylph_tpu_torch.gpu import bucket_fill as bf
    cpb = bf.fill_plan(P, NC, CS)
    return dict(profiler_ms=_profiler_ms(fn, "fill_cells_kernel"),
                occupancy=dict(bf.fill_occupancy(cpb, CS),
                               cells_per_block=cpb))


def _repack_extras(fn, x, live, row: int, cap: int) -> dict:
    """A csrc/repack.cu row's (B3, B8, B11, B12) torch.profiler device
    time a launch, the profiler's time of all the device work of its
    library yardstick (torch.masked_select on the same stream, several
    kernels and a copy), and the card's occupancy readout of its launch
    plan."""
    import torch

    from sylph_tpu_torch.gpu import _cuda
    from sylph_tpu_torch.gpu import bucket_fill as bf
    lib = _cuda.device_ms_calls(lambda: torch.masked_select(x, live), {},
                                20)[0]
    return dict(profiler_ms=_profiler_ms(fn, "repack_kernel"),
                library_profiler_ms="not measured" if lib is None else lib,
                occupancy=bf.repack_occupancy(row, cap, x.dtype))


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

    def record(name, src, replaces, err, ms, plain_ms, nbytes, clocks,
               library_ms=None, n_launches=None, **extra):
        """One kernels-JSON row; the bound is the larger of the bytes the
        call must move over the HBM rate and the SM clocks its operations
        need at least (``_sm_clocks``) over the card's SM clock rate.
        Launches are the GTDB-scale path's unless given (another path's
        count). ``extra`` keys (join.cu's profiler time and occupancy)
        join the row."""
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = clocks / H100_SM_CLOCKS_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source=f"sylph_tpu_torch/csrc/{src}",
            replaces=replaces,
            launches=launches[name] if n_launches is None else n_launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, **extra))
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"bound {max(t_bytes, t_ops):.4f} ms), bit-identical"
              + (f"; {json.dumps(extra)}" if extra else ""))

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
           _live_entries(pw) * 12 + NC * CS * 12, 0,
           **_fill_extras(lambda: bf.bucket_fill(pk, pw, base, **fkw),
                          P, NC, CS))
    dk = got[0].view(B, nt * CS)
    dw = got[1].view(B, nt * CS)
    LW = nt * CS

    # B2 compare + codes + column compaction, at the engine's CAPR
    capr = _capr(density, TB)
    jkw = dict(G=GE, nt=nt, tile=tile)
    got = bj.join_codes_compact(ikey, gidg, dk, dw, CAPR=capr, **jkw)
    want = bj.join_codes_compact_plain(ikey, gidg, dk, dw, CAPR=capr, **jkw)
    err = _same("B2_join_codes_compact", got, want)

    def b2():
        return bj.join_codes_compact(ikey, gidg, dk, dw, CAPR=capr, **jkw)

    record("B2_join_codes_compact", "join.cu",
           "sylph_tpu/tpu/bucket_join.py:290", err, _cuda_ms(b2, 20),
           _cuda_ms(lambda: bj.join_codes_compact_plain(
               ikey, gidg, dk, dw, CAPR=capr, **jkw), 2),
           _join_bytes(ikey, dw, B // TB * capr * CI * 4,
                       bj.join_counts(ikey, dk, dw, nt=nt, tile=tile)),
           _live_compares(ikey, dw, nt, tile) * COMPARE_CLOCKS,
           profiler_ms=_profiler_ms(b2, "join_kernel"),
           **_join_extras("B2_join_codes_compact", bj._MODE_COMPACT, ikey,
                          dk[None], dw[None], nt, tile))

    # B3 repack: the first pass over chunk 0's column-major code stream
    stream = got[0].t().contiguous().view(-1)
    row, cap = _repack_step(stream.numel(), density * TB / capr, 4.0)
    got = bf.repack1_flat(stream, row=row, cap=cap)
    want = bf.repack1_flat_plain(stream, row=row, cap=cap)
    err = _same("B3_repack", (got,), (want,))
    shared = {"codes": (stream, row, cap)}
    live = stream != SENT
    print(f"B3 plan for chunk 0's code stream: {stream.numel()} slots, "
          f"{int(live.sum())} live, (row, cap, nwin) = ({row}, {cap}, "
          f"{bf._n_windows(stream.numel(), row)})")
    record("B3_repack", "repack.cu", "sylph_tpu/tpu/bucket_fill.py:166",
           err, _cuda_ms(lambda: bf.repack1_flat(stream, row=row, cap=cap),
                         50),
           _cuda_ms(lambda: bf.repack1_flat_plain(stream, row=row, cap=cap),
                    5),
           stream.numel() * 4 + got.numel() * 4, 0,
           library_ms=_cuda_ms(lambda: torch.masked_select(stream, live),
                               50),
           **_repack_extras(lambda: bf.repack1_flat(stream, row=row,
                                                     cap=cap),
                            stream, live, row, cap))

    # B4 full code grid, on chunk 0's slice of the dense deep.sylsp
    dpk, dpw, _dP, dCS, _dd = slice0("deep")
    dkw = dict(width=g.width, B=B, CS=dCS, nt=nt, subwidth=sub)
    dfk, dfw = bf.bucket_fill(dpk, dpw, base, **dkw)
    err = _same("B1_fill (deep)", (dfk, dfw),
                bj._sample_to_buckets(dpk, dpw, base=base, **dkw))
    record("B1_fill (deep)", "fill.cu", "sylph_tpu/tpu/bucket_fill.py:278",
           err, _cuda_ms(lambda: bf.bucket_fill(dpk, dpw, base, **dkw), 50),
           _cuda_ms(lambda: bj._sample_to_buckets(dpk, dpw, base=base,
                                                  **dkw), 5),
           _live_entries(dpw) * 12 + NC * dCS * 12, 0,
           n_launches=launches["B1_fill"],
           **_fill_extras(lambda: bf.bucket_fill(dpk, dpw, base, **dkw),
                          dpk.shape[0], NC, dCS))
    ddk, ddw = dfk.view(B, nt * dCS), dfw.view(B, nt * dCS)
    got = bj.join_codes(ikey, gidg, ddk, ddw, **jkw)
    want = bj.join_codes_plain(ikey, gidg, ddk, ddw, **jkw)
    err = _same("B4_join_codes", (got,), (want,))

    def b4():
        return bj.join_codes(ikey, gidg, ddk, ddw, **jkw)

    record("B4_join_codes", "join.cu", "sylph_tpu/tpu/bucket_join.py:241",
           err, _cuda_ms(b4, 20),
           _cuda_ms(lambda: bj.join_codes_plain(ikey, gidg, ddk, ddw,
                                                **jkw), 2),
           _join_bytes(ikey, ddw, B * CI * 4,
                       bj.join_counts(ikey, ddk, ddw, nt=nt, tile=tile)),
           _live_compares(ikey, ddw, nt, tile) * COMPARE_CLOCKS,
           profiler_ms=_profiler_ms(b4, "join_kernel"),
           **_join_extras("B4_join_codes", bj._MODE_CODES, ikey, ddk[None],
                          ddw[None], nt, tile))

    # B5 count grid, as the lossless redo runs it: flat cells at 4x CS
    fk, fw = bf.bucket_fill(pk, pw, base, width=g.width, B=B, CS=4 * CS)
    got = bj.join_counts(ikey, fk, fw)
    want = bj.join_counts_plain(ikey, fk, fw)
    err = _same("B5_join_counts", (got,), (want,))

    def b5():
        return bj.join_counts(ikey, fk, fw)

    record("B5_join_counts", "join.cu", "sylph_tpu/tpu/bucket_join.py:237",
           err, _cuda_ms(b5, 10),
           _cuda_ms(lambda: bj.join_counts_plain(ikey, fk, fw), 1),
           _join_bytes(ikey, fw, B * CI * 4),
           _live_compares(ikey, fw) * COMPARE_CLOCKS,
           profiler_ms=_profiler_ms(b5, "join_kernel"),
           **_join_extras("B5_join_counts", bj._MODE_COUNTS, ikey,
                          fk[None], fw[None]))

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
    counts = bj.join_counts_batched(ikey, dk, dw, nt=nt, tile=g.tile)
    clocks = sum(_live_compares(ikey, dw[s], nt, g.tile)
              for s in range(S)) * COMPARE_CLOCKS
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
         bj._MODE_COMPACT,
         _join_bytes(ikey, dw, S * B // TB * capr * CI * 4, counts)),
        ("B4b_join_codes_batched", "sylph_tpu/tpu/grange.py:923",
         lambda k, x: bj.join_codes_batched(ikey, gidg, k, x, **jkw),
         lambda k, x: bj.join_codes_batched_plain(ikey, gidg, k, x, **jkw),
         lambda k, x: bj.join_codes(ikey, gidg, k, x, **jkw),
         bj._MODE_CODES, _join_bytes(ikey, dw, S * B * CI * 4, counts)),
        ("B5b_join_counts_batched", "sylph_tpu/tpu/grange.py:816",
         lambda k, x: bj.join_counts_batched(ikey, k, x, nt=nt,
                                             tile=g.tile),
         lambda k, x: bj.join_counts_batched_plain(ikey, k, x, nt=nt,
                                                   tile=g.tile),
         lambda k, x: bj.join_counts(ikey, k, x, nt=nt, tile=g.tile),
         bj._MODE_COUNTS, _join_bytes(ikey, dw, S * B * CI * 4)))
    del counts
    for name, replaces, kern, plain, single, mode, nbytes in cases:
        got = kern(dk, dw)
        got = got if isinstance(got, tuple) else (got,)
        want = plain(dk, dw)
        err = _same(name, got, want if isinstance(want, tuple) else (want,))
        at_one(name, kern, single)
        record(name, "join.cu", replaces, err,
               _cuda_ms(lambda: kern(dk, dw), 10),
               _cuda_ms(lambda: plain(dk, dw), 1), nbytes, clocks,
               n_launches=launches[name],
               profiler_ms=_profiler_ms(lambda: kern(dk, dw), "join_kernel",
                                        10),
               **_join_extras(name, mode, ikey, dk, dw, nt, g.tile))


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
                   _live_windows(lens, k) * WINDOW_CLOCKS,
                   **_seed_extras(lambda: sd.seed_packed(packed, lens, c=c,
                                                         k=k)))

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
                               50),
           **_repack_extras(lambda: bf.repack2_flat(stream, row=row,
                                                     cap=cap),
                            stream, live, row, cap))
    print(f"B8 plan for this batch: {plan} (row, cap) passes over "
          f"{stream.numel()} slots, {int(live.sum())} live; the first "
          f"pass's nwin {bf._n_windows(stream.numel(), row)}")
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
            n_launches=launches[name],
            **_repack_extras(lambda: fn(x, row=row, cap=cap), x, live, row,
                             cap))
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
    """B8 and B11 are one kernel on one stream at one (row, cap), over B8's
    windows (padded to a multiple of 8) and B11's rows (padded to its
    Pallas row block): their CUDA-event times in turns (B8, B11, B11, B8),
    beside the host's enqueue time a call and the device time a launch from
    torch.profiler ("not measured" where it shows none). Where the enqueue
    time reaches the event time, the event time of back-to-back calls is
    the host's, not the kernel's."""
    import torch

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
        out[k]["device_ms"] = _profiler_ms(fn, "repack_kernel")
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
    # the identity and its library copy both take under 0.05 ms, where
    # CUDA events mostly time the host: their profiler device times too
    import torch
    x = torch.randint(-(1 << 31), 1 << 31, (kbench.N, kbench.L),
                      dtype=torch.int32, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    ident = dict(profiler_ms=_cuda.device_ms(
        lambda: kbench.launch("identity", x), "kb_identity"),
        library_profiler_ms=_cuda.device_ms_calls(lambda: x.clone(), {},
                                                  20)[0])
    del x
    for r in rows:
        if r["kernel"] is None:
            continue
        if launches[r["kernel"]] <= 0:
            _fail(f"{r['name']} was not launched in (u)")
        # kbench counts its chains' instructions as the ALU pipe's
        record(r["name"], "kbench.cu", r["replaces"], 0.0, r["ms"],
               r["plain_ms"], r["nbytes"], _sm_clocks(alu=r["ops"]),
               library_ms=r["library_ms"], n_launches=launches[r["kernel"]],
               **(ident if r["kernel"] == "kbench_identity" else {}))
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


# ---- (w)-(y): serving, the library API and the trace, c = 1 ---------------

# (y): the smallest 72 of (i)'s assemblies at c=1, enough genomes (>= 64)
# for the device prefilter, so the grange regime sweeps on the card; about
# 9M k-mers (a genome sketch keeps k-mers 30 bases apart), under 2^24,
# half of them >= 2^63; 8 of them planted
C1_GENOMES = 72
C1_PLANTED = 8
C1_MIN_TOP_KEYS = 1_000_000    # (y) needs millions of keys >= 2^63


def _tsv_lines(text):
    """{sample column: [full lines]} of TSV text (a header dropped)."""
    lines = text.splitlines()
    if lines and lines[0].startswith("Sample_file"):
        lines = lines[1:]
    rows = {}
    for line in lines:
        rows.setdefault(line.split("\t", 1)[0], []).append(line)
    return rows


def _device_union_ms(trace_path):
    """(device busy ms, kernel events) of a torch.profiler Chrome trace:
    the union of its kernel, memcpy and memset intervals."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, None
    for a, b in iv:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, sum(1 for e in events if e.get("cat") == "kernel")


def _view_bytes(view) -> int:
    """Device bytes a sample's device view holds."""
    import torch
    n = 0
    for v in vars(view).values():
        for t in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                n += t.numel() * t.element_size()
    return n


class _Requests:
    """(w)'s request stream for runner.serve, which answers a line in full
    (rows written and flushed) before it reads the next. Between two lines
    it records the answered request: wall seconds, launch counts (set to 0
    just before the line is handed over), the rows written meanwhile, its
    stage records and torch.cuda.memory_allocated() after a garbage
    collection. Line ``profile_at`` is answered inside a torch.profiler
    window whose Chrome trace goes to ``trace_path``."""

    def __init__(self, lines, out, stages, profile_at, trace_path):
        self.lines, self.out, self.stages = list(lines), out, stages
        self.profile_at, self.trace_path = profile_at, trace_path
        self.done = []
        self.cold_items = None
        self._i, self._t0, self._pos, self._st, self._prof = -1, 0.0, 0, 0, \
            None

    def __iter__(self):
        return self

    def _close(self):
        import gc

        import torch

        from sylph_tpu_torch.gpu import _cuda
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        text = self.out.getvalue()
        rows, self._pos = text[self._pos:], len(text)
        gc.collect()
        split = {}
        for name, sec in self.stages.items[self._st:]:
            key = name.split(" (")[0]
            split[key] = split.get(key, 0.0) + sec
        self.done.append(dict(line=self.lines[self._i], wall_s=wall,
                              launches=launches, rows=rows, stages=split,
                              mem=torch.cuda.memory_allocated()))

    def __next__(self):
        from sylph_tpu_torch.gpu import _cuda
        if self._i >= 0:
            self._close()
        else:                     # the database is loaded, the header out
            self.cold_items = list(self.stages.items)
            self._pos = len(self.out.getvalue())
        self._i += 1
        if self._i >= len(self.lines):
            raise StopIteration
        if self._i == self.profile_at:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._st = len(self.stages.items)
        _cuda.reset_launches()
        self._t0 = time.perf_counter()
        return self.lines[self._i] + "\n"


def _serve_phase(work, db, reads, samples, host_path, main_tsv):
    """(w): ``runner.serve`` in-process on the main path's database, cold:
    it loads the database and builds the index again. Requests: the three
    sketches and the raw reads, a missing path, a three-token line and
    sample.sylsp again (warm; answered inside a torch.profiler window).
    Every good request's rows equal its sample's rows in (g)'s TSV byte for
    byte, the repeat's the first's; B1, B3 and the compare (B2, or B4 on
    deep.sylsp's dense slices, as on the main path) launch on each good
    request, B7 and B8 on the raw one; device memory after the repeat is
    at most the first good request's plus the device bytes the engine's
    per-sample caches hold and the static buffers of the stream sweeps it
    captured (``GRangeEngine.graph_buffers``, in the allocator's 512-byte
    blocks, and the two blocks of the CUDA generator's graph state)."""
    import io

    import torch

    from sylph_tpu_torch.engine import runner

    sample, deep = samples["sample"][0], samples["deep"][0]
    lines = [sample, reads, deep, host_path,
             os.path.join(work, "missing.sylsp"), f"{sample} {deep} x",
             sample]
    good = {0, 1, 2, 3, 6}
    out = io.StringIO()
    stages = _Stages()
    logger = logging.getLogger("sylph")
    level = logger.level
    logger.setLevel(logging.DEBUG)
    logger.addHandler(stages)
    engines = []
    make = runner._device_engine_for
    runner._device_engine_for = lambda *a, **kw: engines.append(
        make(*a, **kw)) or engines[-1]
    trace = os.path.join(work, "serve_warm.json")
    reqs = _Requests(lines, out, stages, 6, trace)
    t0 = time.perf_counter()
    try:
        runner.serve(runner.ContainOptions(files=[db], device="cuda"),
                     pseudotax=True, out=out, in_stream=reqs)
    finally:
        runner._device_engine_for = make
        logger.removeHandler(stages)
        logger.setLevel(level)
    total = time.perf_counter() - t0
    (dc,) = engines
    cold = {}
    for name, sec in reqs.cold_items:
        key = name.split(" (")[0]
        cold[key] = cold.get(key, 0.0) + sec
    print("serve cold start: " + json.dumps(dict(
        load_s=cold.get("load database"),
        index_build_s=cold.get("grange index build"),
        upload_s=cold.get("grange index upload"))))
    with open(main_tsv) as f:
        want = _tsv_lines(f.read())
    done = reqs.done
    if len(done) != len(lines):
        _fail(f"(w) serve answered {len(done)} of {len(lines)} requests")
    for i, d in enumerate(done):
        print(f"serve request {i} ({os.path.basename(d['line'])}): "
              + json.dumps(dict(wall_s=d["wall_s"], stages=d["stages"],
                                launches=d["launches"],
                                memory_allocated=d["mem"])))
        got = _tsv_lines(d["rows"])
        if i not in good:
            if got:
                _fail(f"(w) bad request {d['line']!r} wrote rows")
            continue
        if len(got) != 1:
            _fail(f"(w) request {d['line']} wrote rows of {len(got)} "
                  "samples")
        (name, mine), = got.items()
        if mine != want.get(name):
            _fail(f"(w) {d['line']}: {len(mine)} rows differ from (g)'s "
                  f"{len(want.get(name, []))} rows of {name}")
        la = d["launches"]
        if not (la.get("B1_fill") and la.get("B3_repack")
                and (la.get("B2_join_codes_compact")
                     or la.get("B4_join_codes"))):
            _fail(f"(w) {d['line']}: B1, B2/B4 and B3 not all launched "
                  f"({la})")
        if d["line"] == reads and not (la.get("B7_seed")
                                       and la.get("B8_repack2")):
            _fail(f"(w) the raw request launched no B7 or B8 ({la})")
    if done[6]["rows"] != done[0]["rows"]:
        _fail("(w) the warm repeat's rows differ from the first serve's")
    print("check (w): every request's rows == (g)'s rows of its sample, "
          "the repeat's == the first's; B1, the compare and B3 launched on "
          "each good request, B7 and B8 on the raw one; both bad lines "
          "skipped")
    cached = [ref for cache in (dc._cache, dc._hists_cache)
              for ref, _ in cache.values()]
    cache_bytes = sum(_view_bytes(s._device_view) for s in cached
                      if getattr(s, "_device_view", None) is not None)
    graph_bytes = sum(-(-t.numel() * t.element_size() // 512) * 512
                      for t in (dc._grange.graph_buffers()
                                if dc._grange is not None else ()))
    if graph_bytes:
        # and what torch keeps while any CUDA graph lives: the CUDA
        # generator's seed and offset for replays, two one-element int64
        # tensors allocated at the first capture (a 512-byte block each)
        graph_bytes += 2 * 512
    growth = done[6]["mem"] - done[0]["mem"]
    case = ("the caches hold host arrays only" if not cache_bytes else
            f"the caches hold {cache_bytes} device bytes of sample views")
    print("serve device memory: " + json.dumps(dict(
        after_first=done[0]["mem"], after_repeat=done[6]["mem"],
        growth=growth, cache_device_bytes=cache_bytes,
        cached_samples=len(cached), case=case,
        graph_buffer_bytes=graph_bytes)))
    if growth > cache_bytes + graph_bytes:
        _fail(f"(w) device memory grew {growth} B between the first request "
              f"and the repeat, above the caches' {cache_bytes} B and the "
              f"captured sweeps' {graph_bytes} B")
    busy_ms, n_kernels = _device_union_ms(trace)
    wall_ms = done[6]["wall_s"] * 1e3
    print("serve warm request under torch.profiler (sample.sylsp): "
          + json.dumps(dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                            busy_share=busy_ms / wall_ms,
                            idle_share=1.0 - busy_ms / wall_ms,
                            kernel_events=n_kernels)))
    if not n_kernels:
        _fail("(w) the warm request's trace shows no kernel")
    print(f"check (w): device memory grew {growth} B (bound "
          f"{cache_bytes + graph_bytes} B: {case}, and {graph_bytes} B of "
          f"captured sweeps' buffers); serve total {total:.3f} s")
    del dc, engines
    torch.cuda.synchronize()


def _row_columns(r, pseudotax: bool):
    """An api.ProfileRow's TSV columns as engine/output.py formats them;
    None where the row has no field (Eff_lambda)."""
    def ci(v, scale):
        return ("NA-NA" if v[0] is None or v[1] is None
                else f"{v[0] * scale:.2f}-{v[1] * scale:.2f}")
    head = [r.sample, r.genome]
    if pseudotax:
        head += [f"{r.rel_abundance:.4f}", f"{r.seq_abundance:.4f}"]
    tail = [f"{r.median_cov:.0f}", f"{r.mean_cov_geq1:.3f}",
            f"{r.containment[0]}/{r.containment[1]}",
            f"{r.naive_ani:.2f}"]
    if pseudotax:
        tail.append(str(r.kmers_reassigned))
    return head + [f"{min(r.adjusted_ani, 100.0):.2f}", f"{r.eff_cov:.3f}",
                   ci(r.ani_ci, 100.0), None, ci(r.lambda_ci, 1.0)] + tail \
        + [r.contig]


def _same_rows(tag, rows, lines, pseudotax):
    got = [_row_columns(r, pseudotax) for r in rows]
    want = [ln.split("\t") for ln in lines]
    if len(got) != len(want) or any(
            len(g) != len(w) or any(a is not None and a != b
                                    for a, b in zip(g, w))
            for g, w in zip(got, want)):
        _fail(f"(x) {tag}: {len(got)} api rows differ from the TSV's "
              f"{len(want)}")


def _api_phase(work, small_db, small, merge_tsvs):
    """(x) on the merge database of (j): ``api.Profiler(db)`` on the card,
    ``.profile(s)`` twice and ``.query(s)``, give (j)'s and (k)'s .syldb
    query rows in every column a ProfileRow holds; two ``contain`` calls
    under SYLPH_TPU_CACHE_INDEX=1 construct one DeviceContainment and give
    the same TSVs; ``profile --profile-trace DIR`` writes a trace holding
    the merge join's device work (its searchsorted and sort kernels)."""
    import sylph_tpu_torch.api as sylph
    from sylph_tpu_torch.engine import device_exec, runner

    spath = small[0]
    tsv_j, tsv_q = merge_tsvs
    texts = {}
    for tag, path in (("profile", tsv_j), ("query", tsv_q)):
        with open(path) as f:
            texts[tag] = f.read()
    db = sylph.load_db(small_db)
    smp = sylph.load_sample(spath)
    want_p = _tsv_lines(texts["profile"])[smp.file_name]
    want_q = _tsv_lines(texts["query"])[smp.file_name]
    built = [0]
    real_init = device_exec.DeviceContainment.__init__

    def init(self, *a, **kw):
        built[0] += 1
        real_init(self, *a, **kw)

    device_exec.DeviceContainment.__init__ = init
    try:
        t0 = time.perf_counter()
        prof = sylph.Profiler(db)
        t_build = time.perf_counter() - t0
        if prof.device.type != "cuda":
            _fail(f"(x) Profiler(db) runs on {prof.device}")
        times = []
        for i in range(2):
            t0 = time.perf_counter()
            rows = prof.profile(smp)
            times.append(time.perf_counter() - t0)
            _same_rows(f"Profiler.profile, call {i + 1}", rows, want_p, True)
        t0 = time.perf_counter()
        _same_rows("Profiler.query", prof.query(smp), want_q, False)
        times.append(time.perf_counter() - t0)
        if built[0] != 1:
            _fail(f"(x) Profiler built {built[0]} engines")
        del prof
        os.environ["SYLPH_TPU_CACHE_INDEX"] = "1"
        built[0] = 0
        walls = []
        for mode in ("profile", "query"):
            out = os.path.join(work, f"cached_{mode}.tsv")
            _, wall, _, _ = _drive([mode, small_db, spath, "-o", out])
            walls.append(wall)
            with open(out) as f:
                if f.read() != texts[mode]:
                    _fail(f"(x) the cached-index {mode} TSV differs")
        if built[0] != 1:
            _fail(f"(x) two contain calls under SYLPH_TPU_CACHE_INDEX=1 "
                  f"constructed {built[0]} engines")
    finally:
        device_exec.DeviceContainment.__init__ = real_init
        os.environ.pop("SYLPH_TPU_CACHE_INDEX", None)
        runner._ENGINE_CACHE.clear()
        runner._SKETCH_CACHE.clear()
    print("check (x): Profiler on the card: profile twice and query == "
          "(j)'s and (k)'s rows, one engine; two contain calls under "
          "SYLPH_TPU_CACHE_INDEX=1 built one engine, TSVs unchanged")
    tdir = os.path.join(work, "trace")
    out = os.path.join(work, "traced.tsv")
    launches, wall, _, _ = _drive(["profile", small_db, spath,
                                   "--profile-trace", tdir, "-o", out])
    with open(out) as f:
        if f.read() != texts["profile"]:
            _fail("(x) the traced profile's TSV differs from (j)'s")
    files = os.listdir(tdir)
    if len(files) != 1:
        _fail(f"(x) --profile-trace wrote {files}")
    path = os.path.join(tdir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    join = [n for n in names if "searchsorted" in n or "sort" in n.lower()]
    if not join:
        _fail(f"(x) the trace holds {len(names)} kernels, none of the "
              "merge join's (searchsorted, sort)")
    busy_ms, _ = _device_union_ms(path)
    print("api and trace: " + json.dumps(dict(
        profiler_build_s=t_build, profiler_calls_s=times,
        cached_contain_walls_s=walls, traced_profile_wall_s=wall,
        trace_bytes=os.path.getsize(path), trace_kernels=len(names),
        merge_join_kernels=len(join), trace_device_busy_ms=busy_ms)))
    print("check (x): --profile-trace wrote a trace holding the merge "
          "join's kernels; its TSV == (j)'s")


def _c1_phase(a, work, asm_paths):
    """(y): c = 1 on the card. 72 of (i)'s assemblies sketched with
    ``sketch -c 1 -g`` (millions of keys >= 2^63, under 2^24 k-mers; 64
    genomes or more, so the grange regime's device prefilter sweeps), a
    planted c = 1 sample profiled in the merge regime, the bucket regime
    (BUCKET_MIN lowered) and the grange regime (GRANGE_MIN lowered, as (v)
    forces it): the three TSVs equal and list exactly the planted genomes,
    the grange histograms equal the oracle, and B1 on the grange chunk
    slice holding keys >= 2^63 equals its plain version."""
    import torch

    from sylph_tpu_torch.core.types import SequencesSketch
    from sylph_tpu_torch.engine.device_exec import DeviceContainment
    from sylph_tpu_torch.gpu import bucket_fill as bf
    from sylph_tpu_torch.gpu import bucket_join as bj
    from sylph_tpu_torch.gpu import grange as gr
    from sylph_tpu_torch.io import sylformat

    paths = [p for _, p in sorted((os.path.getsize(p), p)
                                  for p in asm_paths)[:C1_GENOMES]]
    size = sum(os.path.getsize(p) for p in paths)
    base = os.path.join(work, "c1")
    launches, wall, _, _ = _drive(["sketch", "-c", "1", "-g", *paths, "-o",
                                   base, "-t", str(THREADS)])
    if launches["B7_seed"] <= 0:
        _fail("(y) sketch -c 1 launched no B7")
    db = base + ".syldb"
    genomes = sylformat.read_syldb(db)
    keys = np.concatenate([g.genome_kmers for g in genomes])
    top = np.uint64(1 << 63)
    n_top = int((keys >= top).sum())
    if n_top < C1_MIN_TOP_KEYS or keys.size >= 1 << 24:
        _fail(f"(y) {keys.size} k-mers, {n_top} of them >= 2^63")
    rng = np.random.default_rng(a.seed + 6)
    picks = rng.choice(len(genomes), size=C1_PLANTED, replace=False)
    parts = [genomes[g].genome_kmers for g in np.sort(picks)]
    counts = [1 + rng.poisson(1 + j % 5, size=p.size)
              for j, p in enumerate(parts)]
    absent = np.setdiff1d(rng.integers(0, np.iinfo(np.uint64).max,
                                       size=2_000_000, dtype=np.uint64), keys)
    parts.append(absent)
    counts.append(rng.integers(1, 4, size=absent.size))
    sk = SequencesSketch(np.concatenate(parts),
                         np.concatenate(counts).astype(np.uint32), 1, K,
                         "c1.fq", None, False, 150.0)
    spath = os.path.join(work, "c1.sylsp")
    sylformat.write_sylsp(spath, sk)
    smp = sylformat.read_sylsp(spath)
    planted = {genomes[g].file_name for g in picks}
    old = (DeviceContainment.BUCKET_MIN, DeviceContainment.GRANGE_MIN)
    tsvs, splits = {}, {}
    try:
        for regime in ("merge", "bucket", "grange"):
            DeviceContainment.BUCKET_MIN = 0 if regime == "bucket" \
                else old[0]
            DeviceContainment.GRANGE_MIN = 0 if regime == "grange" \
                else old[1]
            out = os.path.join(work, f"c1_{regime}.tsv")
            la, w, _, dc = _drive(["profile", db, spath, "-c", "1", "-o",
                                   out])
            ran = ("grange" if dc._grange is not None else
                   "bucket" if dc._use_buckets else "merge")
            if ran != regime:
                _fail(f"(y) the {regime} profile ran the {ran} regime")
            if regime != "merge" and la["B1_fill"] <= 0:
                _fail(f"(y) the {regime} profile launched no B1")
            if regime == "grange" and dc._grange.counters["hists_sweeps"] < 1:
                _fail(f"(y) the grange profile swept no chunk: "
                      f"{dc._grange.counters}")
            with open(out) as f:
                tsvs[regime] = f.read()
            splits[regime] = dict(wall_s=w, launches={
                k: v for k, v in la.items() if v})
            if regime == "grange":
                gdc = dc
            del dc
    finally:
        DeviceContainment.BUCKET_MIN, DeviceContainment.GRANGE_MIN = old
    if len(set(tsvs.values())) != 1:
        _fail("(y) the c = 1 TSVs differ between regimes: " + json.dumps(
            {k: len(v) for k, v in tsvs.items()}))
    listed = {r.split("\t")[0] for r in _tsv_rows(
        os.path.join(work, "c1_merge.tsv")).get("c1.fq", [])}
    if listed != planted:
        _fail(f"(y) the c = 1 TSV lists {len(listed)} genomes, "
              f"{len(listed & planted)} of {len(planted)} planted")
    s_k, s_c = smp.sorted_view()
    got = gdc.hists(smp)
    if not np.array_equal(got, _oracle_hist(genomes, s_k, s_c, gdc.device)):
        _fail("(y) the c = 1 grange histogram differs from the oracle")
    eng = gdc._grange
    g = eng.gidx
    slices, P, CS, _ = eng.plan(np.ascontiguousarray(s_k, np.uint64))
    ci = max(range(len(slices)), key=lambda i: int(g.edges_u64[i, 1]))
    skey, sw = eng.upload_sample(s_k, s_c)
    s0, e0 = slices[ci]
    ck, cw = gr._pad_slice(skey, sw.to(torch.int32), s0, e0, P)
    n_top_slice = int((ck.cpu().numpy().view(np.uint64)[:e0 - s0]
                       >= top).sum())
    if not n_top_slice:
        _fail("(y) the chunk slice holds no key >= 2^63")
    kw = dict(width=g.width, B=g.B, CS=CS, nt=g.nt, subwidth=g.subwidth)
    err = _same("B1 c=1 slice",
                bf.bucket_fill(ck, cw, int(g.bases[ci]), **kw),
                [t.to(ck.device) for t in bj._sample_to_buckets(
                    ck.cpu(), cw.cpu(), base=int(g.bases[ci]), **kw)])
    print("c = 1: " + json.dumps(dict(
        assemblies=len(paths), fasta_bytes=size, index_kmers=int(keys.size),
        keys_ge_2_63=n_top, sample_kmers=int(smp.kmers.size),
        sketch_s=wall, grange_chunks=len(g.chunk_keys),
        b1_slice=dict(chunk=ci, entries=e0 - s0, keys_ge_2_63=n_top_slice,
                      P=P, CS=CS, nt=g.nt, max_abs_err=err),
        **splits)))
    print(f"check (y): merge, bucket and grange TSVs equal at c = 1 "
          f"({len(planted)} planted genomes listed), grange histograms == "
          "oracle, B1 on a uint64-ordered slice == plain")
    del gdc, eng
    torch.cuda.synchronize()


# ---- (z)-(ab): several devices and several processes, on the one card ------
#
# The card is one H100: (z) gives one engine two logical devices on it,
# (aa) runs two processes on it and (ab) two ranks. They hold placement,
# ownership, the collectives and the merges to exact results with the real
# kernels; they say nothing of scaling over GPUs.

MP_TIMEOUT_S = 600             # each group of processes, killed past it


def _save_layout(dc, work):
    """The main engine's grange layout saved once with SYLPH_GRANGE_CACHE's
    writer (for (z) and (aa)); prints its seconds and bytes. Returns (the
    cache directory, the layout's path, total k-mers, genomes)."""
    from sylph_tpu_torch.engine.device_exec import (_grange_cache_path,
                                                    _grange_cache_save)
    g = dc._grange.gidx
    cache = os.path.join(work, "grange_cache")
    path = _grange_cache_path(cache, int(g.m), dc._genome_sketches)
    t0 = time.perf_counter()
    _grange_cache_save(path, g)
    sec = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    print("grange layout cache save (GTDB scale): " + json.dumps(dict(
        seconds=sec, bytes=size, chunks=len(g.chunk_keys),
        disk_free_bytes=shutil.disk_usage(work).free)))
    return cache, path, int(g.m), len(dc._genome_sketches), \
        len(g.chunk_keys)


def _multidevice_phase(work, samples, oracles, layout, small_db, small,
                       merge_tsv, cohort):
    """(z): one process, two logical devices on the one card. The main
    path's layout, loaded from (3)'s cache, in a GRangeEngine on [cuda:0,
    cuda:0]: sample.sylsp's and deep.sylsp's histograms equal (a)'s oracle
    and a one-device engine's (each sweep timed, then that engine's on the
    same sample), each launch count a sweep is the chunk count (B1, and B2
    or B4) or more (B3's chains). Then DeviceContainment on [cuda:0,
    cuda:0] in (j)'s and (o)'s calls: the sharded merge join, TSVs equal
    (j)'s and (o)'s byte for byte, (o)'s cohort in one batched sharded
    join."""
    import torch

    from sylph_tpu_torch.engine import runner
    from sylph_tpu_torch.engine.device_exec import (DeviceContainment,
                                                    _grange_cache_load)
    from sylph_tpu_torch.gpu import _cuda
    from sylph_tpu_torch.gpu.grange import GRangeEngine
    from sylph_tpu_torch.io import sylformat

    two = [torch.device("cuda", 0)] * 2
    _cache, path, total, n_genomes, _n = layout
    t0 = time.perf_counter()
    gidx = _grange_cache_load(path, total, n_genomes)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = GRangeEngine(gidx, devices=two)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    one = GRangeEngine(gidx, devices=two[:1])     # one device, beside it
    n = len(gidx.chunk_keys)
    out = dict(cache_load_s=load_s, upload_s=upload_s, chunks=n)
    for name in ("sample", "deep"):
        sk, sc = sylformat.read_sylsp(samples[name][0]).sorted_view()
        sk = sk.astype(np.uint64)
        _cuda.reset_launches()
        t0 = time.perf_counter()
        got = eng.hists(sk, sc)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        la = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        got1 = one.hists(sk, sc)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        if not (np.array_equal(got, oracles[name])
                and np.array_equal(got1, got)):
            _fail(f"(z) {name} on two devices: [G, 64] histogram differs "
                  f"from (a)'s oracle in {int((got != oracles[name]).sum())}"
                  f" bins, from one device's in {int((got != got1).sum())}")
        cmp_ = la["B2_join_codes_compact"] + la["B4_join_codes"]
        if la["B1_fill"] != n or cmp_ != n or la["B3_repack"] < n:
            _fail(f"(z) {name}: B1 {la['B1_fill']}, B2+B4 {cmp_}, B3 "
                  f"{la['B3_repack']} launches for {n} chunks")
        out[name] = dict(sweep_s=sweep_s, one_device_sweep_s=one_s,
                         B1=la["B1_fill"], B2=la["B2_join_codes_compact"],
                         B4=la["B4_join_codes"], B3=la["B3_repack"],
                         B5=la["B5_join_counts"])
    out["hists_sweeps"] = eng.counters["hists_sweeps"]
    del eng, one, gidx
    gc.collect()
    torch.cuda.empty_cache()
    print(f"check (z): the {n}-chunk index on two devices of the one card "
          "gives (a)'s histograms for sample and deep; B1 and B2/B4 once a "
          "chunk")
    make = runner._device_engine_for
    runner._device_engine_for = (
        lambda gsf, gf, gs, device: DeviceContainment(gs, devices=two))
    try:
        tsv_j = os.path.join(work, "z_small.tsv")
        _l, wall_j, _st, dc = _drive(["profile", small_db, small[0], "-o",
                                      tsv_j])
        if dc._shards is None or dc.counters["sharded_joins"] < 1:
            _fail(f"(z) (j)'s call took no sharded join: {dc.counters}")
        _same_file(tsv_j, merge_tsv, "(z) sharded (j)")
        paths, cohort_tsv = cohort
        tsv_o = os.path.join(work, "z_cohort.tsv")
        _l, wall_o, _st, dco = _drive(["profile", small_db, *paths, "-o",
                                       tsv_o])
        if dco.counters != {"batched_joins": 1, "sharded_joins": 1}:
            _fail(f"(z) (o)'s cohort: not one batched sharded join: "
                  f"{dco.counters}")
        _same_file(tsv_o, cohort_tsv, "(z) sharded (o)")
    finally:
        runner._device_engine_for = make
    out.update(merge_sharded_wall_s=wall_j, cohort_sharded_wall_s=wall_o,
               index_slots=int(dc.index.keys.size))
    del dc, dco
    print(f"check (z): DeviceContainment on two devices takes the sharded "
          f"merge join; (j)'s and (o)'s TSVs byte for byte, (o)'s "
          f"{len(paths)} samples in one batched sharded join")
    print("multi-device (z), two devices sharing one H100: "
          + json.dumps(out))


def _process_phase(work, db, samples, main_tsv, layout):
    """(aa): two processes on the main path's database and the one card:
    ``profile db.syldb sample.sylsp deep.sylsp --coordinator ...
    --num-processes 2 --process-id i`` with SYLPH_GRANGE_CACHE set (each
    loads only its chunks' grids of (3)'s cache), through cli.main in
    ``python -m sylph_tpu_torch.multichip worker cli`` (which reports the
    call's launches, stages and device memory). Process 0's TSV holds the
    main call's rows for both samples byte for byte; process 1 writes
    nothing; each launches B1 and B2/B4 on exactly its chunks, per sample."""
    from sylph_tpu_torch import multichip

    cache, _path, _total, _g, n_chunks = layout
    addr = f"127.0.0.1:{multichip.free_port()}"
    outs = [os.path.join(work, f"aa_out{i}.tsv") for i in range(2)]
    reps = [os.path.join(work, f"aa_report{i}.json") for i in range(2)]
    names = [samples[n][0] for n in ("sample", "deep")]
    argvs = [multichip.worker_argv(
        "cli", addr, 2, i, "--report", reps[i], "--", "profile", db, *names,
        "-o", outs[i], "--coordinator", addr, "--num-processes", "2",
        "--process-id", str(i), "--debug") for i in range(2)]
    t0 = time.perf_counter()
    res = multichip.run_ranks(argvs, MP_TIMEOUT_S, env=dict(
        os.environ, SYLPH_GRANGE_CACHE=cache))
    wall = time.perf_counter() - t0
    for i, (rc, _so, se) in enumerate(res):
        if rc != 0:
            _fail(f"(aa) process {i} exited {rc}:\n{se[-3000:]}")
    if os.path.exists(outs[1]) or res[1][1]:
        _fail("(aa) process 1 wrote output")
    got, main = _tsv_rows(outs[0]), _tsv_rows(main_tsv)
    want = {f"{n}.fq": main[f"{n}.fq"] for n in ("sample", "deep")}
    if got != want:
        _fail(f"(aa) process 0's rows differ from the main call's: "
              f"{ {k: len(v) for k, v in got.items()} } rows against "
              f"{ {k: len(v) for k, v in want.items()} }")
    per = []
    for i, rep in enumerate(reps):
        with open(rep) as f:
            r = json.load(f)
        la = r["launches"]
        split = {}
        for name, sec in r["stages"]:
            key = name.split(" (")[0]
            split[key] = split.get(key, 0.0) + sec
        per.append(dict(process=i, wall_s=r["wall_s"], stages=split,
                        launches=la,
                        max_memory_allocated=r["max_memory_allocated"]))
        owned = len(range(i, n_chunks, 2))
        cmp_ = la.get("B2_join_codes_compact", 0) + la.get("B4_join_codes",
                                                            0)
        if la.get("B1_fill", 0) != owned * len(names) or \
                cmp_ != owned * len(names) or "grange cache load" not in split:
            _fail(f"(aa) process {i}: launches {la} for {owned} chunks of "
                  f"{n_chunks} and {len(names)} samples, stages "
                  f"{sorted(split)}")
    print(f"check (aa): two processes, each sweeping only its own "
          f"{n_chunks // 2} or so of the {n_chunks} chunks (B1 and B2/B4 "
          "once a chunk and sample); process 0's TSV == the main call's "
          "rows for sample and deep; process 1 wrote nothing")
    print("two processes (aa), sharing one H100: " + json.dumps(dict(
        wall_s=wall, per_process=per)))


def _step_phase(work, step_dir, q_ref):
    """(ab): make_sharded_profile_step on (q)'s 64 batches and index: two
    gloo ranks sharing the card (dp = 2, ip = 1), each taking half of every
    batch's reads and half the index, then one NCCL rank (world size 1).
    Every rank's histogram equals (q)'s and its statistics (q)'s within
    rtol 1e-5; B6 and B8 launch in every rank."""
    import torch

    from sylph_tpu_torch import multichip
    from sylph_tpu_torch.gpu.stats import GenomeStats

    q_hist, q_st = q_ref
    out = {}
    for backend, world in (("gloo", 2), ("nccl", 1)):
        addr = f"127.0.0.1:{multichip.free_port()}"
        base = os.path.join(work, f"ab_{backend}")
        t0 = time.perf_counter()
        res = multichip.run_ranks([multichip.worker_argv(
            "step", addr, world, r, "--backend", backend, "--device", "cuda",
            "--data", step_dir, "--out", base) for r in range(world)],
            MP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for r, (rc, _so, se) in enumerate(res):
            if rc != 0:
                _fail(f"(ab) {backend} rank {r} exited {rc}:\n{se[-3000:]}")
        ranks = []
        for r in range(world):
            z = np.load(f"{base}.rank{r}.npz")
            la = json.loads(str(z["launches"]))
            if not np.array_equal(z["hist"], q_hist):
                _fail(f"(ab) {backend} rank {r}: histogram differs from "
                      f"(q)'s in {int((z['hist'] != q_hist).sum())} bins")
            _stats_close(f"(ab) {backend} rank {r}", GenomeStats(
                *[torch.from_numpy(z[f]) for f in GenomeStats._fields]),
                q_st)
            if la.get("B6_seed_pack", 0) < 1 or la.get("B8_repack2", 0) < 1:
                _fail(f"(ab) {backend} rank {r}: launches {la}")
            ranks.append(dict(rank=r, step_s=float(z["wall_s"]),
                              dp=int(z["dp"]), ip=int(z["ip"]), launches=la,
                              max_memory_allocated=int(
                                  z["max_memory_allocated"])))
        out[backend] = dict(wall_s=wall, ranks=ranks)
    print("check (ab): the sharded step on (q)'s data, two gloo ranks "
          "sharing the card (dp = 2) and one NCCL rank, == (q)'s histogram "
          "and statistics; B6 and B8 launched in every rank")
    print("sharded step (ab), ranks sharing one H100: " + json.dumps(out))


# ---- (ac): the port's bench (sylph_tpu_torch/bench.py) --------------------

BENCH_REPS = 2                 # timed reps a config (the bench takes 5-7)
BENCH_SAMPLES = 4              # gtdb --samples
# (ad): gbench at full width; dupskew cut to fit the time limit (its
# defaults: --unique 2^28 --sample 2e6 in 2^25-slot chunks)
GBENCH_VARIANTS = ("prefix", "joinonly", "joinstages", "dense75", "seed_t",
                   "fused8")
DUPSKEW_UNIQUE = 1 << 17      # the uniform profile's index: 8 full chunks
DUPSKEW_SAMPLE = 50_000
DUPSKEW_CHUNK = 1 << 14       # 16 buckets at the GTDB chunks' mean
GBENCH_REPS = 2               # the tool's default: 3
# (ad) profiles joinstages' lines only (B5's time among them): in this
# long-lived process the profiler drops some of B6's launches in every
# window, and each window costs seconds
GBENCH_PROFILED = ("join:prep", "join:fill", "join:+compare",
                   "join:+codes", "join:full")
INGEST_BLOCKS = 2


def _launched():
    from sylph_tpu_torch.gpu import _cuda
    return {k: v for k, v in _cuda.LAUNCHES.items() if v}


def _gtdb_oracle(gidx, stream, G: int):
    """[G, 64] histograms of the sample stream, folded on the host
    (np.unique), against every live key of the index on the card."""
    flat = stream.reshape(-1).cpu().numpy()
    sk, sc = np.unique(flat[flat != -1].view(np.uint64), return_counts=True)

    def blocks():
        for keys, gid in zip(gidx.chunk_keys, gidx.chunk_gid):
            k = keys.reshape(-1)
            live = k != -1
            yield k[live], gid.reshape(-1)[live]
    return _oracle_blocks(blocks(), sk, sc, G, stream.device)


def _gtdb_device_time(run_once, reps: int = 3):
    """One timed gtdb run's wall ms, and its device ms by torch.profiler
    over ``reps`` runs: all device activity, and the ten names that take
    the most (ms and launches a run)."""
    from torch.autograd import DeviceType

    from sylph_tpu_torch.gpu import _cuda
    t0 = time.perf_counter()
    run_once()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in _cuda._profile(run_once, reps)
          if e.device_type == DeviceType.CUDA]
    total = sum(_cuda._device_us(e) for e in ev) / reps / 1e3
    if not total:
        _fail("(ac) the profiler recorded no device time for a gtdb run")
    top = sorted(ev, key=_cuda._device_us, reverse=True)[:10]
    return dict(wall_ms=wall_ms, device_ms=total, profiled_runs=reps,
                top=[dict(name=e.key[:80],
                          ms=_cuda._device_us(e) / reps / 1e3,
                          launches=e.count / reps) for e in top])


def _bench_gtdb_checks(info, G: int, KPG: int):
    """(ac)'s checks of a gtdb run: the index's first and last chunks equal
    the host replay, its live slots its m; the last timed run's [G, 64]
    histogram equals the oracle."""
    from sylph_tpu_torch.gpu import synth_index as si
    gidx = info["index"]
    n = len(gidx.chunk_keys)
    if (n, gidx.B, gidx.CI) != (22, 32768, 1152):
        _fail(f"(ac) synthetic index of {n} chunks of [{gidx.B}, "
              f"{gidx.CI}], not 22 of [32768, 1152]")
    t0 = time.perf_counter()
    replay = si.synth_chunks_host(G, KPG, C, nt=gidx.nt, chunks=[0, n - 1])
    replay_s = time.perf_counter() - t0
    for i, (hk, hg) in zip((0, n - 1), replay):
        if not (np.array_equal(gidx.chunk_keys[i].cpu().numpy(), hk) and
                np.array_equal(gidx.chunk_gid[i].cpu().numpy(), hg)):
            _fail(f"(ac) synthetic chunk {i} differs from its host replay")
    live = sum(int((k != -1).sum()) for k in gidx.chunk_keys)
    if live != gidx.m:
        _fail(f"(ac) {live} live slots on the card, m = {gidx.m}")
    t0 = time.perf_counter()
    want = _gtdb_oracle(gidx, info["stream"], G)
    got = info["hist"][:G * 64].reshape(G, 64).cpu().numpy()
    if not np.array_equal(got, want):
        _fail(f"(ac) gtdb [G, 64] histogram differs from the oracle in "
              f"{int((got != want).sum())} bins")
    if int(want[:, 1:].sum()) == 0:
        _fail("(ac) gtdb matched nothing")
    return dict(replay_s=replay_s, oracle_s=time.perf_counter() - t0,
                live_slots=live, hits=int(want.sum()))


def _bench_phase(work, db, reads, n_bases, layout, asm_paths):
    """(ac): the port's bench through its own functions, each config with
    the launch counts set to 0 just before it, BENCH_REPS timed reps: gtdb
    (the index made on the card: 22 chunks of [32768, 1152]; chunk 0 and
    the last equal to the host replay, the live count to m; the last timed
    run's histogram equal to a searchsorted oracle of its sample folded on
    the host; every run's probe exact; one run's wall and device time), gtdb --dup (the expansion's ok and the probe
    in every run), gtdb --samples 4 (each batched row equal to its own
    sweep), profile, sketch, multisample, entry() (its histogram equal to
    its plain run on the CPU), gtdb_cli on (3)'s db.syldb and
    reads.fastq.gz with (3)'s saved layout, sketchdb on (i)'s assemblies.
    Prints each config's JSON line, stage split and launches."""
    import torch

    from sylph_tpu_torch import bench as tb
    from sylph_tpu_torch.gpu import _cuda
    from sylph_tpu_torch.gpu import synth_index as si
    from sylph_tpu_torch.multichip import entry

    dev = torch.device("cuda")
    G, KPG = 100_000, 7168
    out = {}

    def run(name, fn):
        gc.collect()
        torch.cuda.empty_cache()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = dict(wall_s=time.perf_counter() - t0,
                         launches=_launched())
        return res

    gbps, info = run("gtdb", lambda: tb._bench_gtdb(
        G, KPG, device=dev, reps=BENCH_REPS))
    for k in ("B1_fill", "B3_repack", "B6_seed_pack", "B8_repack2"):
        if out["gtdb"]["launches"].get(k, 0) < 1:
            _fail(f"(ac) gtdb: {k} not launched: {out['gtdb']['launches']}")
    out["gtdb"].update(line=tb.result_line("gtdb_profile_throughput", gbps),
                       **{k: info[k] for k in (
                           "synth_s", "plants_s", "upload_s", "warmup_s",
                           "median_s", "n_live", "n_unique", "n_matches")},
                       **_bench_gtdb_checks(info, G, KPG))
    out["gtdb"]["run_time"] = _gtdb_device_time(info["run_once"])
    del info
    gbps, info = run("gtdb_dup", lambda: tb._bench_gtdb(
        G, KPG, device=dev, dup=si.DupSpec(), reps=BENCH_REPS))
    out["gtdb_dup"].update(
        line=tb.result_line("gtdb_profile_throughput_dupskew", gbps),
        n_heavy=info["index"].n_heavy, chunks=len(info["index"].chunk_keys),
        **{k: info[k] for k in ("synth_s", "plants_s", "warmup_s",
                                "median_s", "n_matches")})
    del info
    gbps, info = run("gtdb_samples", lambda: tb._bench_gtdb(
        G, KPG, device=dev, n_samples=BENCH_SAMPLES,
        batched_reps=BENCH_REPS))
    eng, seed_all = info["engine"], info["seed_all"]
    rows = torch.cat(info["hists"])
    ge = eng.gidx.g_eff * 64
    for s in range(BENCH_SAMPLES):
        h, probe, P = eng.hist_device_stream(seed_all(s))
        if int(probe[0]) != 0 or int(probe[1]) > P:
            _fail(f"(ac) samples: sample {s}'s own sweep is not exact")
        if not torch.equal(rows[s], h[:ge]):
            _fail(f"(ac) samples: sample {s}'s batched row differs from its "
                  f"own sweep in {int((rows[s] != h[:ge]).sum())} bins")
    out["gtdb_samples"].update(
        line=tb.result_line("gtdb_profile_throughput", gbps),
        **{k: info[k] for k in ("synth_s", "plants_s", "warmup_s",
                                "median_s")})
    del info, eng, seed_all, rows, h
    bases, lengths, idx_dev = tb._profile_inputs(dev)
    out["profile"] = {"line": tb.result_line("profile_throughput", run(
        "profile", lambda: tb._bench_profile(bases, lengths, idx_dev, dev,
                                             reps=BENCH_REPS)))}
    out["sketch"] = {"line": tb.result_line("sketch_throughput", run(
        "sketch", lambda: tb._bench_sketch_only(bases, lengths, dev)))}
    sps = run("multisample", lambda: tb._bench_multisample(
        bases, lengths, idx_dev, dev))
    out["multisample"] = {"line": json.dumps({
        "metric": "multisample_containment", "value": round(sps, 3),
        "unit": "samples/s", "vs_baseline": None})}
    del bases, lengths, idx_dev
    fn, args = entry()
    h, ani, cov = run("entry", lambda: fn(*args))
    fc, ac = entry(device="cpu")
    hc, anic, covc = fc(*ac)
    if not torch.equal(h.cpu(), hc) or int(hc[:, 1:].sum()) == 0:
        _fail("(ac) entry(): the card's histogram differs from the plain "
              "run's")
    np.testing.assert_allclose(ani.cpu().numpy(), anic.numpy(), rtol=1e-5)
    np.testing.assert_allclose(cov.cpu().numpy(), covc.numpy(), rtol=1e-5)
    out["gtdb_cli"] = {"line": tb.result_line(
        "gtdb_cli_file_to_tsv_throughput", run("gtdb_cli", lambda:
            tb._bench_gtdb_cli(dev, db=db, reads=reads, cache_dir=layout[0],
                               reps=1, warm=1, total_bp=n_bases)))}
    out["sketchdb"] = {"line": tb.result_line(
        "sketch_db_build_throughput", run("sketchdb", lambda:
            tb._bench_sketchdb(dev, gdir=os.path.join(work, "sketchdb"),
                               reps=1, paths=asm_paths)), baseline=False)}
    for name, rec in out.items():
        if "line" in rec:
            print(f"bench (ac) {name}: {rec['line']}")
    print("check (ac): gtdb's synthetic index (22 x [32768, 1152]) == host "
          "replay at chunks 0 and 21 and its m; gtdb histogram == oracle, "
          "every probe exact; --dup ok; --samples 4 rows == own sweeps; "
          "entry() == plain run")
    print("bench (ac): " + json.dumps(out))


def _host_engine_checks(work, merge, bucket):
    """(ad), first part: ``profile`` and ``query --device host`` of the
    merge database and ``profile --device host`` of the bucket database
    against the card's TSVs of the same calls, (j)'s, (k)'s and (l)'s (the
    bucket query is cut: ``reduced``)."""
    out = {}
    for tag, (db, smp, card) in (("merge", merge), ("bucket", bucket)):
        for mode, want in card.items():
            got = os.path.join(work, f"ad_{tag}_{mode}_host.tsv")
            launches, wall, _s, dc = _drive([mode, db, smp, "-o", got,
                                             "--device", "host"])
            if dc is not None or any(launches.values()):
                _fail(f"(ad) --device host {mode} of {tag} built a device "
                      f"engine or launched kernels: "
                      f"{ {k: v for k, v in launches.items() if v} }")
            _same_file(got, want, f"(ad) --device host {mode} of {tag}")
            out[f"{tag}_{mode}_host_s"] = wall
            with open(want) as f:
                out[f"{tag}_{mode}_rows"] = sum(1 for _ in f) - 1
    print("check (ad): --device host profile and query of the merge "
          "database and profile of the bucket database == the card's TSVs, "
          "no kernel launched")
    return out


def _devtools_phase(work, merge, bucket, reads, rows):
    """(ad): the host engine against the card, then gbench, dupskew,
    stage_timing and profile_ingest, each with the launch counts set to 0
    just before it and its checks required."""
    import torch

    from sylph_tpu_torch import dupskew, gbench, profile_ingest, stage_timing
    from sylph_tpu_torch.gpu import _cuda

    dev = torch.device("cuda")
    out = {"host_engine": _host_engine_checks(work, merge, bucket)}

    def run(name, fn):
        gc.collect()
        torch.cuda.empty_cache()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = dict(wall_s=time.perf_counter() - t0,
                         launches=_launched())
        print(f"(ad) {name}: " + json.dumps(res))
        return res

    g = run("gbench", lambda: gbench.run(
        100_000, GBENCH_REPS, 64, 65536, 7168, "device", True, dev,
        GBENCH_VARIANTS, profiled=GBENCH_PROFILED))
    comp = g["lines"]["join:+compare"]
    n_b5 = comp["launches"].get("B5_join_counts", 0)
    if n_b5 != g["index"]["chunks"]:
        _fail(f"(ad) gbench joinstages launched B5 {n_b5} times, not once "
              f"a chunk ({g['index']['chunks']})")
    b5 = comp["kernels"].get("join_kernel")
    for r in rows:
        if r["name"] == "B5_join_counts":
            r.update(gbench_launches=n_b5,
                     gbench_profiler_ms=None if b5 is None else b5["ms"])
    out["gbench"].update(
        lines={k: dict(best_ms=v["best_ms"], device_ms=v["device_ms"])
               for k, v in g["lines"].items()}, b5=b5, checks=g["checks"])
    del g
    d = run("dupskew", lambda: dupskew.run(
        DUPSKEW_UNIQUE, 25_000, dupskew.PROFILES, (1, 4), DUPSKEW_SAMPLE,
        DUPSKEW_CHUNK, dev))
    out["dupskew"]["table"] = [
        {k: r[k] for k in ("profile", "nt", "CI", "lane", "spill_frac",
                           "heavy", "stream_ms", "parity", "dparity")}
        for r in d]
    st = run("stage_timing", lambda: stage_timing.run(dev))
    out["stage_timing"].update(stages=st["stages"])
    pi = run("profile_ingest", lambda: profile_ingest.run(
        reads, INGEST_BLOCKS, dev))
    out["profile_ingest"].update(warm=pi["warm"], gbp=pi["gbp"],
                                 batches=pi["batches"])
    print("check (ad): gbench variants == full == oracle, B5 once a chunk "
          "in joinstages; dupskew parity and dparity OK at nt 1 and 4; "
          "stage_timing and profile_ingest agree")
    print("devtools (ad): " + json.dumps(out))


def main(argv=None) -> int:
    a = _parse(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from sylph_tpu_torch.gpu import _cuda

    smi = _cuda.card_line()
    print(smi)
    with open("/proc/meminfo") as f:
        print("host: " + json.dumps(dict(
            mem_total=f.readline().split(":")[1].strip(),
            cpus=os.cpu_count())))
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
    # (ac) runs each bench config once, on data the script made
    reduced.update(
        bench_timed_reps=["5-7 (bench.py)", BENCH_REPS],
        bench_gtdb_cli="(3)'s db.syldb (uniform random k-mers) and "
        "reads.fastq.gz (2^30 bases), the layout loaded from (3)'s cache, "
        "1 warm-up and 1 timed run, in place of bench_fixtures gtdb_cli",
        bench_sketchdb="(i)'s 256 assemblies (1.05 Gbp), 1 run, in place "
        "of 107 x 10 Mbp",
        bench_e2e="not run: its fixture costs minutes of gzip",
        host_engine_grange="--device host of the main grange database not "
        "run in (ad): its host prefilter probes 7.2e8 index k-mers (the "
        "gtdb_cli host golden took 399 s); python -m "
        "sylph_tpu_torch.host_golden holds that scale in a call of its own",
        host_engine_bucket_query="--device host query of (l)'s bucket "
        "database not run in (ad) (its host run took 26 s and the card's "
        "10 s); the bucket profile and the merge profile and query are",
        dupskew=dict(unique=[1 << 28, DUPSKEW_UNIQUE],
                     sample=["2e6", DUPSKEW_SAMPLE],
                     chunk_slots=[1 << 25, DUPSKEW_CHUNK]),
        gbench_reps=[3, GBENCH_REPS],
        gbench_profiled=["every line", list(GBENCH_PROFILED)],
        profile_ingest_blocks=[4, INGEST_BLOCKS])
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
        layout = _save_layout(dc, work)
        loaded = _check_outputs(dc, samples, tsv)
        oracles = {n: loaded[n][3] for n in ("sample", "deep")}
        host_tbl = _check_reads(dc, reads, card, host_path, abundant, tsv,
                                per, ingest)
        cohort = {samples[n][0]: loaded[n][3] for n in ("sample", "deep")}
        cohort[host_path] = host_tbl[2]
        c_launches = _cohort_phase(dc, db, cohort, tsv, per)
        batch, blens, q_launches, s_launches, step_dir, q_ref = \
            _profile_phase(a, dc.device, work)
        r_batch = _gtdb_pipeline_phase(dc, read_codes)
        del read_codes
        small_db, asm_paths, sk_launches = _sketch_phase(a, work)
        genomes, small, merge_tsvs = _merge_phase(a, work, small_db)
        cohort_o = _merge_cohort_phase(a, work, small_db, genomes, small)
        bdc, bsmp, b_launches, bucket_paths = _bucket_phase(a, work)
        rows, record, shared = _kernels(dc, loaded, launches, reads)
        _batched_kernels(dc, [loaded["sample"][1:3], loaded["deep"][1:3],
                              host_tbl[:2]], c_launches, record)
        _small_db_kernels(bdc, bsmp, asm_paths, b_launches, sk_launches,
                          record)
        _pipeline_kernels(dc.device, batch, blens, q_launches, s_launches,
                          r_batch, record)
        for tag, phase in (
                ("t", lambda: _row_repack_phase(shared, record)),
                ("u", lambda: _kbench_phase(record)),
                ("v", lambda: _cache_phase(work, bucket_paths))):
            t0 = time.perf_counter()
            phase()
            print(f"phase ({tag}): {time.perf_counter() - t0:.3f} s")
        # the main path's engines are done with: (w) builds its own
        del dc, bdc, card, shared, loaded
        gc.collect()
        torch.cuda.empty_cache()
        for tag, phase in (
                ("w", lambda: _serve_phase(
                    work, db, reads, samples, host_path, tsv)),
                ("x", lambda: _api_phase(work, small_db, small,
                                         merge_tsvs)),
                ("y", lambda: _c1_phase(a, work, asm_paths)),
                ("z", lambda: _multidevice_phase(
                    work, samples, oracles, layout, small_db, small,
                    merge_tsvs[0], cohort_o)),
                ("aa", lambda: _process_phase(work, db, samples, tsv,
                                              layout)),
                ("ab", lambda: _step_phase(work, step_dir, q_ref)),
                ("ac", lambda: _bench_phase(work, db, reads, n_bases, layout,
                                            asm_paths)),
                ("ad", lambda: _devtools_phase(
                    work, (small_db, small[0], {"profile": merge_tsvs[0],
                                                "query": merge_tsvs[1]}),
                    (bucket_paths[0], bucket_paths[1],
                     {"profile": bucket_paths[2]}), reads, rows))):
            t0 = time.perf_counter()
            phase()
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase ({tag}): {time.perf_counter() - t0:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if _cuda.PROFILE_MISSES:
        print("profiler windows that showed another number of launches "
              "(kernel, launches, reps), each taken again: "
              f"{_cuda.PROFILE_MISSES}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
