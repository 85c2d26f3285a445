"""query/profile orchestration (counterpart of sylph_tpu/engine/runner.py).

Behavioral spec: sylph ``contain`` (src/contain.rs:115-351) and its helpers
``get_genome_sketches`` (:482-542), ``get_seq_sketch`` (:544-599),
``get_stats`` (:601-814). Containment always runs through the device engine
(engine/device_exec.py) on ``opts.device``; statistics stay in host f64, so
TSVs are byte-identical to sylph_tpu's host engine. Genomes are .syldb
databases or fasta files, sketched on the same device; samples are .sylsp
sketches or raw reads (fastq, -r, -1/-2), sketched there too while, in the
grange regime, their k-mers stream to it. Samples run in cohorts of
``SYLPH_COHORT_DEPTH`` (runner.py:599-636 of the JAX package): raw-read
samples first, then sketches, each cohort loading on a thread pool while the
one before it is processed, its device work batched by
``DeviceContainment.prefetch``; results come out in input order.

``serve`` (``--serve``) loads the database and builds the device engine
once, then answers one sample request a line of a stream. Under
``SYLPH_TPU_CACHE_INDEX=1`` the parsed database and its device engine stay
resident across ``contain`` calls of one process (a library caller's
repeated calls), keyed on the ``.syldb`` files' paths, times and sizes.
``--profile-trace DIR`` writes a torch.profiler trace of the sample loop.
In a group of several processes (``--coordinator``) every process runs the
same call and only process 0 writes (``_secondary_process``).

``device="host"`` (``--device host``) is the JAX package's host engine, its
CLI without ``--tpu`` (runner.py:538-562, 627-642 there): no device engine
and no kernel, reads and fasta genomes seeded by the native C seeder, the
prefilter's histograms from host searchsorted probes
(engine/prefilter.py::host_counts_chunks), the exact statistics from host
probes, and samples processed ``sample_parallelism_step`` at a time on a
thread pool, written in input order. It runs only when asked for by name.
"""

import logging
import math
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, TextIO

import torch

from ..constants import (DEFAULT_C, DEFAULT_FPR, DEFAULT_K,
                         DEFAULT_MIN_COUNT_CORRECT,
                         DEFAULT_MIN_NUMBER_KMERS, DEFAULT_MIN_SPACING,
                         DEFAULT_REDUNDANT_ANI, MIN_ANI_DEF, MIN_ANI_P_DEF,
                         QUERY_FILE_SUFFIX_VALID, SAMPLE_FILE_SUFFIX_VALID)
from ..core.sketch_genomes import sketch_genome, sketch_genome_individual
from ..core.sketch_reads import sketch_pair_sequences, sketch_sequences
from ..core.types import AniResult, GenomeSketch, SequencesSketch
from ..gpu.grange import resolve_device
from ..utils.distributed import process_count, process_index
from ..io import sylformat
from ..io.fastx import is_fasta, is_fastq
from ..stats.contain_stats import StatParams, coverage_stats
from ..utils.timing import maybe_profile, stage_timer
from .containment import WinnerTable, genome_covs, genome_covs_batch
from .output import print_ani_result, print_header
from .profile import (assign_groups, derep_if_reassign_threshold,
                      estimate_covered_bases, estimate_true_cov,
                      get_kmer_identity, winner_table)

log = logging.getLogger("sylph")


@dataclass
class ContainOptions:
    """Mirrors ContainArgs (sylph src/cmdline.rs:85-164)."""
    files: List[str] = field(default_factory=list)
    file_list: Optional[str] = None
    min_count_correct: float = DEFAULT_MIN_COUNT_CORRECT
    min_number_kmers: float = DEFAULT_MIN_NUMBER_KMERS
    minimum_ani: Optional[float] = None
    threads: int = 3
    sample_threads: Optional[int] = None
    estimate_unknown: bool = False
    seq_id: Optional[float] = None
    redundant_ani: float = DEFAULT_REDUNDANT_ANI
    reads: List[str] = field(default_factory=list)
    first_pair: List[str] = field(default_factory=list)
    second_pair: List[str] = field(default_factory=list)
    c: int = DEFAULT_C
    k: int = DEFAULT_K
    individual: bool = False
    min_spacing_kmer: int = DEFAULT_MIN_SPACING
    out_file_name: Optional[str] = None
    log_reassignments: bool = False
    pseudotax: bool = False
    estimator: str = "ratio"   # ratio|mme|nb|mle (hidden flags)
    no_ci: bool = False
    no_adj: bool = False
    mean_coverage: bool = False
    device: str = "cuda"       # "cuda", "cpu", or "host" (no device engine)
    profile_trace: Optional[str] = None  # torch.profiler trace output dir


HOST = "host"                  # the device name of the host engine


def engine_device(device) -> Optional[torch.device]:
    """None for ``"host"`` (the host engine: the native C seeder and numpy
    probes, no GPU and no kernel), else the resolved torch device; asking
    for CUDA without a GPU raises."""
    return None if device == HOST else resolve_device(device)


def sample_parallelism_step(pseudotax: bool, threads: int,
                            sample_threads: Optional[int],
                            num_raw_read_files: int) -> int:
    """Concurrent-sample worker count of the host engine (sylph
    src/contain.rs:239-256).

    The reference counts RAW read files only (pre-sketched .sylsp samples
    are cheap to load and don't justify extra workers); profile floors at
    threads/3+1 so the nested per-genome parallelism keeps 2/3 of the pool.
    """
    if sample_threads is not None:
        return sample_threads if sample_threads > 0 else 1
    if pseudotax:
        return max(threads // 3 + 1, min(num_raw_read_files, threads))
    return max(1, min(num_raw_read_files, threads))


def _stat_params(opts: ContainOptions, k: int) -> StatParams:
    return StatParams(k=k, min_count_correct=opts.min_count_correct,
                      estimator=opts.estimator, no_ci=opts.no_ci,
                      no_adj=opts.no_adj, mean_coverage=opts.mean_coverage)


def get_stats(opts: ContainOptions, genome: GenomeSketch, genome_index: int,
              sample: SequencesSketch, winner: Optional[WinnerTable] = None,
              self_group: int = -1,
              log_reassign: bool = False,
              device_engine=None,
              covs_kl=None) -> Optional[AniResult]:
    """Engine half of sylph get_stats (src/contain.rs:601-814).

    ``covs_kl``: precomputed (covs, kmers_lost) from genome_covs_batch —
    the profile passes probe all candidates in one batch."""
    if genome.k != sample.k:
        log.error("k parameter for reads %s != k parameter for genome %s",
                  sample.k, genome.k)
        raise SystemExit(1)
    if genome.c < sample.c:
        log.error("c parameter for reads %s > c parameter for genome %s",
                  sample.c, genome.c)
        raise SystemExit(1)
    n_kmers = int(genome.genome_kmers.size)
    if float(n_kmers) < opts.min_number_kmers:
        return None
    if covs_kl is not None:
        covs, kmers_lost = covs_kl
    elif device_engine is not None:
        covs, kmers_lost = device_engine.genome_covs(
            genome_index, sample, winner, self_group)
    else:
        covs, kmers_lost = genome_covs(genome, sample, winner, self_group)
    if covs.size == 0:
        return None
    min_ani = (opts.minimum_ani / 100.0 if opts.minimum_ani is not None
               else (MIN_ANI_P_DEF if opts.pseudotax else MIN_ANI_DEF))
    # profiling pass 1 (winner None): its CI columns are never printed —
    # only pass-2 rows reach the TSV — and each bootstrap reseeds
    # wyrand(7), so skipping them changes no downstream number
    st = coverage_stats(covs, n_kmers, _stat_params(opts, genome.k),
                        min_ani,
                        run_ci_if_pass=not (opts.pseudotax
                                            and winner is None))
    if st is None:
        if winner is not None and log_reassign:
            log.info(
                "Genome/contig %s/%s dropped below ANI threshold after "
                "reassigning %d k-mers (%d contained k-mers after reassign)",
                genome.file_name, genome.first_contig_name, kmers_lost,
                int(covs.size))
        return None
    seq_name = (sample.sample_name if sample.sample_name is not None
                else sample.file_name)
    return AniResult(
        naive_ani=st.naive_ani,
        final_est_ani=st.final_est_ani,
        final_est_cov=st.final_est_cov,
        seq_name=seq_name,
        gn_name=genome.file_name,
        contig_name=genome.first_contig_name,
        mean_cov=st.mean_cov,
        median_cov=st.median_cov,
        containment_index=(int(covs.size), n_kmers),
        lam=st.lam,
        ani_ci=st.ani_ci,
        lambda_ci=st.lambda_ci,
        genome_sketch=genome,
        genome_index=genome_index,
        kmers_lost=kmers_lost if winner is not None else None,
    )


def _classify_files(opts: ContainOptions):
    """src/contain.rs:149-223 -> (genome sketches, genome fasta files, read
    sketches, raw read inputs as [file] or [R1, R2])."""
    all_files = list(opts.files)
    if opts.file_list:
        with open(opts.file_list) as f:
            all_files.extend(line.rstrip("\n") for line in f)
    genome_sketch_files, genome_files = [], []
    read_sketch_files, read_files = [], []
    for f in all_files:
        if any(f.endswith(s) for s in QUERY_FILE_SUFFIX_VALID):
            genome_sketch_files.append(f)
        elif any(f.endswith(s) for s in SAMPLE_FILE_SUFFIX_VALID):
            read_sketch_files.append(f)
        elif is_fasta(f):
            genome_files.append(f)
        elif is_fastq(f):
            read_files.append([f])
        else:
            log.warning("%s file extension is not a sketch or a fasta/fastq "
                        "file.", f)
    if len(opts.first_pair) != len(opts.second_pair):
        log.error("Different number of paired sequences (-1, -2) for "
                  "sketching. Exiting.")
        raise SystemExit(1)
    for a, b in zip(opts.first_pair, opts.second_pair):
        read_files.append([a, b])
    for r in opts.reads:
        read_files.append([r])
    return genome_sketch_files, genome_files, read_sketch_files, read_files


_SKETCH_CACHE = {}      # db key -> List[GenomeSketch] (opt-in)


def _db_key(genome_sketch_files):
    """The resident caches' key: the sorted (abspath, mtime, size) of the
    .syldb files, so a rewritten database misses."""
    return tuple(sorted(
        (os.path.abspath(p), os.path.getmtime(p), os.path.getsize(p))
        for p in genome_sketch_files))


def _caching(genome_sketch_files, genome_files) -> bool:
    """SYLPH_TPU_CACHE_INDEX=1 and a database of .syldb files only (fasta
    inputs are sketched in-call and not fingerprinted: they bypass the
    caches)."""
    return (os.environ.get("SYLPH_TPU_CACHE_INDEX") == "1"
            and bool(genome_sketch_files) and not genome_files)


def _get_genome_sketches(opts: ContainOptions, genome_sketch_files,
                         genome_files, device) -> List[GenomeSketch]:
    """src/contain.rs:482-542: .syldb inputs, then fasta inputs sketched
    with seeding on ``device``. Under SYLPH_TPU_CACHE_INDEX=1 the parsed
    sketch list of one database stays resident (runner.py:191-253 of the
    JAX package): re-reading a GTDB-scale .syldb costs seconds a call."""
    serving = _caching(genome_sketch_files, genome_files)
    if serving:
        key = _db_key(genome_sketch_files)
        hit = _SKETCH_CACHE.get(key)
        if hit is not None:
            return hit
    max_genome_c = None   # reference's 'lowest_genome_c' actually tracks max
    current_k = None
    sketches: List[GenomeSketch] = []
    for path in genome_sketch_files:
        try:
            vec = sylformat.read_syldb(path)
        except (OSError, sylformat.SketchFormatError):
            log.error("The sketch `%s` is not a valid sketch. Perhaps it is "
                      "an older, incompatible version ", path)
            raise SystemExit(1)
        if not vec:
            continue
        c = vec[0].c
        k = vec[0].k
        if max_genome_c is None or max_genome_c < c:
            max_genome_c = c
        if current_k is None:
            current_k = k
        elif current_k != k:
            log.error("Query sketches have inconsistent -k. Exiting.")
            raise SystemExit(1)
        sketches.extend(vec)
    for path in genome_files:
        if max_genome_c is not None and max_genome_c < opts.c:
            log.error("Value of -c for contain is %s -- greater than the "
                      "smallest value of -c for a genome sketch %s. "
                      "Continuing without sketching.", opts.c, max_genome_c)
        elif current_k is not None and current_k != opts.k:
            log.error("-k %s is not equal to -k %s found in sketches. "
                      "Continuing without sketching.", opts.k, current_k)
        elif opts.individual:
            sketches.extend(sketch_genome_individual(
                opts.c, opts.k, path, opts.min_spacing_kmer, opts.pseudotax,
                device=device))
        else:
            g = sketch_genome(opts.c, opts.k, path, opts.min_spacing_kmer,
                              opts.pseudotax, device=device)
            if g is not None:
                sketches.append(g)
    if serving:
        _SKETCH_CACHE.clear()          # hold at most one resident database
        _SKETCH_CACHE[key] = sketches
    return sketches


def _get_seq_sketch(opts: ContainOptions, read_file: List[str],
                    is_sketch: bool, genome_c: int, genome_k: int,
                    device, streamer=None) -> Optional[SequencesSketch]:
    """src/contain.rs:544-599: a .sylsp input, or raw reads sketched with
    seeding on ``device`` while their k-mers stream to ``streamer``."""
    if is_sketch:
        path = read_file[0]
        try:
            sk = sylformat.read_sylsp(path)
        except (OSError, sylformat.SketchFormatError):
            log.error("The sketch `%s` is not a valid sketch. Perhaps it is "
                      "an older incompatible version ", path)
            raise SystemExit(1)
        if sk.c > genome_c:
            log.error("%s value of -c is %s; this is greater than the "
                      "smallest value of -c = %s for a genome sketch. "
                      "Exiting.", path, sk.c, genome_c)
            return None
        if sk.c < genome_c:
            log.info("%s value of -c for reads is %s; this is smaller than "
                     "the -c for a genome sketch. Using the larger -c %s "
                     "instead.", path, sk.c, genome_c)
        return sk
    if genome_c < opts.c:
        log.error("%s error: value of -c for contain = %s -- greater than "
                  "the smallest value of -c for a genome sketch = %s. "
                  "Continuing without sketching.", read_file[0], opts.c,
                  genome_c)
        return None
    if genome_k != opts.k:
        log.error("%s -k %s is not equal to -k %s found in sketches. "
                  "Continuing without sketching.", read_file[0], opts.k,
                  genome_k)
        return None
    on_segment = streamer.push if streamer is not None else None
    if len(read_file) == 1:
        return sketch_sequences(read_file[0], opts.c, opts.k, None, False,
                                device=device, on_segment=on_segment)
    # on-the-fly paired sketching uses DEFAULT_FPR like the reference
    # (src/contain.rs:591)
    return sketch_pair_sequences(read_file[0], read_file[1], opts.c, opts.k,
                                 None, False, fpr=DEFAULT_FPR, device=device,
                                 on_segment=on_segment)


def _load_sample(opts: ContainOptions, read_file: List[str],
                 is_sketch: bool, genome_sketches, device_engine):
    """Read or sketch one sample. A raw-read sample streams its k-mers to
    the device during the sketch; the finished stream becomes the
    sample's device view (runner.py:564-585 of the JAX package). With no
    device engine (the host engine) reads are seeded by the native C
    seeder and nothing streams."""
    streamer = (None if is_sketch or device_engine is None
                else device_engine.sample_streamer())
    sk = None
    try:
        sk = _get_seq_sketch(opts, read_file, is_sketch,
                             genome_sketches[0].c, genome_sketches[0].k,
                             device_engine.device if device_engine else None,
                             streamer=streamer)
    finally:
        if streamer is not None:
            if sk is not None:
                with stage_timer("stream finalize"):
                    sk._device_view = streamer.finalize(sk.kmers, sk.counts)
            else:
                streamer.close()
    return sk


def process_sample(opts: ContainOptions, sample: SequencesSketch,
                   genome_sketches: List[GenomeSketch],
                   device_engine=None) -> List[AniResult]:
    """One sample vs all genomes (body of src/contain.rs:267-339)."""
    first_read_file = sample.file_name
    if opts.seq_id is not None:
        kmer_id_opt = math.pow(opts.seq_id / 100.0, float(sample.k))
    else:
        with stage_timer("kmer identity estimate"):
            kmer_id_opt = get_kmer_identity(sample, opts.estimate_unknown)
        if kmer_id_opt is not None:
            log.debug("%s has estimated identity %.3f.", first_read_file,
                      math.pow(kmer_id_opt, 1.0 / sample.k) * 100.0)

    from .prefilter import prefilter_candidates
    with stage_timer("pass-1 prefilter"):
        candidates = prefilter_candidates(opts, sample, genome_sketches,
                                          device_engine)
    if candidates is None:
        candidate_iter = enumerate(genome_sketches)
    else:
        # the prefilter skips get_stats' per-genome k/c compatibility
        # checks for dropped genomes — run them upfront so incompatible
        # databases still fail loudly (src/contain.rs:603-622)
        for g in genome_sketches:
            if g.k != sample.k:
                log.error("k parameter for reads %s != k parameter for "
                          "genome %s", sample.k, g.k)
                raise SystemExit(1)
            if g.c < sample.c:
                log.error("c parameter for reads %s > c parameter for "
                          "genome %s", sample.c, g.c)
                raise SystemExit(1)
        log.debug("%s: batched prefilter kept %d/%d genomes for the exact "
                  "statistics pass.", first_read_file, candidates.size,
                  len(genome_sketches))
        candidate_iter = ((int(i), genome_sketches[int(i)])
                          for i in candidates)

    # the grange engine serves histograms only, so its exact statistics
    # probe the host; the merge and bucket regimes read their cached
    # device counts (device_engine.genome_covs)
    host_probe = device_engine is None or device_engine.serves_histograms()

    def _batchable(genomes):
        # cap the concat: an unfiltered 100k-genome query would
        # materialize the whole database's k-mers
        return (1 < len(genomes)
                and sum(g.genome_kmers.size for g in genomes) <= (1 << 26))

    def _stats_map(fn, n_items):
        """Order-preserving map over per-genome get_stats calls, threaded
        like the reference's nested genome par_iter
        (src/contain.rs:284-292) when the pool is worth it."""
        if n_items < 8 or opts.threads <= 1 or opts.log_reassignments \
                or not host_probe:
            # the device counts are filled on first use: one thread, so
            # first calls cannot run duplicate joins
            return [fn(j) for j in range(n_items)]
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(opts.threads, 8)) as ex:
            return list(ex.map(fn, range(n_items)))

    candidate_list = list(candidate_iter)
    results = []
    with stage_timer("pass-1 exact stats"):
        batch = None
        if host_probe and _batchable([g for _, g in candidate_list]):
            batch = genome_covs_batch([g for _, g in candidate_list],
                                      sample)

        def one1(j):
            i, g = candidate_list[j]
            return get_stats(opts, g, i, sample, None, -1,
                             opts.log_reassignments, device_engine,
                             covs_kl=batch[j] if batch is not None
                             else None)

        for r in _stats_map(one1, len(candidate_list)):
            if r is not None:
                results.append(r)
    estimate_true_cov(results, kmer_id_opt, opts.estimate_unknown,
                      sample.mean_read_length, sample.k)

    if opts.pseudotax:
        log.info("%s taxonomic profiling; reassigning k-mers for %d "
                 "genomes...", first_read_file, len(results))
        with stage_timer("winner table"):
            winner = winner_table(results, opts.log_reassignments)
        groups = assign_groups(results)
        results2 = []
        with stage_timer("pass-2 reassigned stats"):
            batch2 = None
            if host_probe and _batchable([r.genome_sketch
                                          for r in results]):
                batch2 = genome_covs_batch(
                    [r.genome_sketch for r in results], sample,
                    winner, list(groups))
            groups_l = list(groups)

            def one2(j):
                r = results[j]
                return get_stats(opts, r.genome_sketch, r.genome_index,
                                 sample, winner, groups_l[j],
                                 opts.log_reassignments, device_engine,
                                 covs_kl=(batch2[j] if batch2 is not None
                                          else None))

            for r2 in _stats_map(one2, len(results)):
                if r2 is not None:
                    results2.append(r2)
        results = derep_if_reassign_threshold(results, results2,
                                              opts.redundant_ani, sample.k)
        estimate_true_cov(results, kmer_id_opt, opts.estimate_unknown,
                          sample.mean_read_length, sample.k)
        log.info("%s has %d genomes passing profiling threshold. ",
                 first_read_file, len(results))
        bases_explained = 1.0
        if opts.estimate_unknown:
            bases_explained = estimate_covered_bases(
                results, sample, sample.mean_read_length, sample.k)
            log.info("%s has %.2f%% of reads detected in database by "
                     "profile", first_read_file, bases_explained * 100.0)
        total_cov = sum(r.final_est_cov for r in results)
        total_seq_cov = sum(r.final_est_cov * float(r.genome_sketch.gn_size)
                            for r in results)
        for r in results:
            r.rel_abund = r.final_est_cov / total_cov * 100.0
        for r in results:
            r.seq_abund = (r.final_est_cov * float(r.genome_sketch.gn_size)
                           / total_seq_cov * 100.0 * bases_explained)
        results.sort(key=lambda r: -r.rel_abund)
    else:
        results.sort(key=lambda r: -r.final_est_ani)
    return results


def cohort_depth(device_engine) -> int:
    """Samples per cohort: ``SYLPH_COHORT_DEPTH``, else 1 where the engine
    serves streamed samples (grange: the host ingest dominates, so sample
    i+1 loads while sample i is processed) and 8 elsewhere (the batched
    merge join)."""
    env = os.environ.get("SYLPH_COHORT_DEPTH")
    if env:
        return max(1, int(env))
    return 1 if device_engine.serves_streams() else 8


def _cohorts(opts: ContainOptions, items, genome_sketches, device_engine):
    """(read files, results or None) per sample, in input order
    (runner.py:599-636 of the JAX package). The next cohort's loads are
    submitted to a thread pool before the current cohort is processed; a
    cohort of more than one loaded sample is prefetched as a batch. A
    sample that fails to load (None) is skipped in place; an error raised
    in a load, SystemExit from a bad .sylsp included, reaches the caller
    through Future.result()."""
    depth = cohort_depth(device_engine)
    groups = [items[i:i + depth] for i in range(0, len(items), depth)]

    def load(item):
        rf, is_sketch = item
        with stage_timer("load/sketch sample", detail=rf[0]):
            return rf, _load_sample(opts, rf, is_sketch, genome_sketches,
                                    device_engine)

    with ThreadPoolExecutor(max_workers=max(1, min(opts.threads, depth))
                            ) as pool:
        pend = [pool.submit(load, it) for it in groups[0]] if groups else []
        for gi in range(len(groups)):
            cur = [f.result() for f in pend]
            pend = ([pool.submit(load, it) for it in groups[gi + 1]]
                    if gi + 1 < len(groups) else [])
            loaded = [s for _, s in cur if s is not None]
            if len(loaded) > 1:
                device_engine.prefetch(loaded)
            for rf, sample in cur:
                if sample is None:
                    yield rf, None
                    continue
                with stage_timer("process sample", detail=rf[0],
                                 items=len(genome_sketches)):
                    results = process_sample(opts, sample, genome_sketches,
                                             device_engine)
                yield rf, results


def _host_samples(opts: ContainOptions, items, genome_sketches, n_raw: int):
    """(read files, results or None) per sample on the host engine, in
    input order: each sample loaded and processed by one worker of a pool
    of ``sample_parallelism_step`` threads (runner.py:556-562, 627-642 of
    the JAX package), or in turn where that is 1."""
    step = sample_parallelism_step(opts.pseudotax, opts.threads,
                                   opts.sample_threads, n_raw)

    def handle(item):
        rf, is_sketch = item
        with stage_timer("load/sketch sample", detail=rf[0]):
            sample = _load_sample(opts, rf, is_sketch, genome_sketches, None)
        if sample is None:
            return rf, None
        with stage_timer("process sample", detail=rf[0],
                         items=len(genome_sketches)):
            return rf, process_sample(opts, sample, genome_sketches, None)

    if step == 1 or len(items) <= 1:
        yield from map(handle, items)
        return
    with ThreadPoolExecutor(max_workers=step) as ex:
        yield from ex.map(handle, items)


_ENGINE_CACHE = {}      # (db key, device) -> DeviceContainment (opt-in)


def _device_engine_for(genome_sketch_files, genome_files, genome_sketches,
                       device):
    """The device engine of this database on ``device``: one per call, or
    under SYLPH_TPU_CACHE_INDEX=1 one resident engine reused by later
    calls on the same .syldb files and device (runner.py:453-475 of the
    JAX package), which skip the index build and upload. None for the
    host engine (``device`` None)."""
    from .device_exec import DeviceContainment
    if device is None:
        return None
    if not _caching(genome_sketch_files, genome_files):
        return DeviceContainment(genome_sketches, device=device)
    key = (_db_key(genome_sketch_files), str(device))
    if key not in _ENGINE_CACHE:
        _ENGINE_CACHE.clear()          # hold at most one resident index
        _ENGINE_CACHE[key] = DeviceContainment(genome_sketches,
                                               device=device)
    return _ENGINE_CACHE[key]


def _secondary_process() -> bool:
    """True in a process of a group of several processes (``--coordinator``,
    utils/distributed.py) other than process 0 (runner.py:478-489 of the
    JAX package). Every process runs the same pipeline: the grange engine
    splits the chunks and merges the histograms, so every process computes
    the same rows, and only process 0 writes them."""
    return process_count() > 1 and process_index() != 0


def _open_out(opts: ContainOptions, out: Optional[TextIO]):
    """(the TSV stream, whether to close it): os.devnull in a secondary
    process, else ``out``, else -o, else stdout."""
    if _secondary_process():
        return open(os.devnull, "w"), True
    if out is not None:
        return out, False
    if opts.out_file_name:
        return open(opts.out_file_name, "w"), True
    return sys.stdout, False


def _log_devices(device_engine) -> None:
    if device_engine is None:
        log.info("Containment runs on the host engine (no device).")
        return
    devs = device_engine.devices
    log.info("Containment runs on %d device(s) (%s)%s.", len(devs),
             ", ".join(map(str, devs)),
             f", process {process_index()} of {process_count()}"
             if process_count() > 1 else "")


def _load_database(opts: ContainOptions, need_samples: bool):
    """(classified inputs, device, genome sketches) of a contain or serve
    call; exits 1 where src/contain.rs does (no database, no samples, an
    empty database, profiling of a --disable-profiling database)."""
    log.info("Obtaining sketches...")
    files = _classify_files(opts)
    genome_sketch_files, genome_files, read_sketch_files, read_files = files
    if not genome_sketch_files and not genome_files:
        log.error("No genome files found; see sylph query/profile -h for "
                  "help. Exiting")
        raise SystemExit(1)
    if need_samples and not read_sketch_files and not read_files:
        log.error("No read files found; see sylph query/profile -h for "
                  "help. Exiting")
        raise SystemExit(1)
    device = engine_device(opts.device)
    with stage_timer("load database"):
        genome_sketches = _get_genome_sketches(opts, genome_sketch_files,
                                               genome_files, device)
    log.info("Finished obtaining genome sketches.")
    if not genome_sketches:
        log.error("No genome sketches found; see sylph query/profile -h for "
                  "help. Exiting")
        raise SystemExit(1)
    if (genome_sketches[0].pseudotax_tracked_nonused_kmers is None
            and opts.pseudotax):
        log.error("Attempting profiling, but *.syldb was sketched with the "
                  "--disable-profiling option. Exiting")
        raise SystemExit(1)
    return files, device, genome_sketches


def contain(opts: ContainOptions, pseudotax: bool,
            out: Optional[TextIO] = None):
    """Entry point for query (pseudotax=False) / profile (pseudotax=True)."""
    from ..utils.threads import set_thread_budget
    set_thread_budget(opts.threads)
    if pseudotax:
        opts.pseudotax = True
    ((genome_sketch_files, genome_files, read_sketch_files, read_files),
     device, genome_sketches) = _load_database(opts, need_samples=True)
    device_engine = _device_engine_for(genome_sketch_files, genome_files,
                                       genome_sketches, device)
    _log_devices(device_engine)

    out, close_out = _open_out(opts, out)
    print_header(opts.pseudotax, out, opts.estimate_unknown)
    samples = ([(rf, False) for rf in read_files]
               + [([f], True) for f in read_sketch_files])
    with maybe_profile(opts.profile_trace):
        outputs = (_cohorts(opts, samples, genome_sketches, device_engine)
                   if device_engine is not None else
                   _host_samples(opts, samples, genome_sketches,
                                 len(read_files)))
        for rf, results in outputs:
            if results is not None:
                for r in results:
                    print_ani_result(r, opts.pseudotax, out)
                out.flush()
            log.info("Finished %ssample %s.",
                     "paired " if len(rf) > 1 else "", rf[0])
    log.info("sylph finished.")
    if close_out:
        out.close()


def serve(opts: ContainOptions, pseudotax: bool,
          out: Optional[TextIO] = None,
          in_stream: Optional[TextIO] = None):
    """Resident-index serving loop (``profile/query --serve``;
    runner.py:659-788 of the JAX package).

    Loads the database and builds the device engine on ``opts.device``
    ONCE, then serves the samples given in argv, then one request per line
    of ``in_stream`` (default stdin): a read-file or .sylsp path, or two
    whitespace-separated paths for a read pair. A raw-read request on a
    grange engine streams its k-mers to the device while it is sketched.
    Each request's TSV rows are written and flushed before the next line is
    read. A bad line or a failed sample (a bad .sylsp's SystemExit too)
    logs and continues; EOF ends the loop. There is no fall-back to the
    host: without a GPU, ``device="cuda"`` raises as in ``contain``;
    ``device="host"`` serves on the host engine (runner.py:713-725 of the
    JAX package)."""
    from ..utils.threads import set_thread_budget
    set_thread_budget(opts.threads)
    if pseudotax:
        opts.pseudotax = True
    if in_stream is None:
        in_stream = sys.stdin
    ((genome_sketch_files, genome_files, read_sketch_files, read_files),
     device, genome_sketches) = _load_database(opts, need_samples=False)
    device_engine = _device_engine_for(genome_sketch_files, genome_files,
                                       genome_sketches, device)
    _log_devices(device_engine)
    out, close_out = _open_out(opts, out)
    print_header(opts.pseudotax, out, opts.estimate_unknown)

    def one(rfiles: List[str], is_sketch: bool) -> None:
        with stage_timer("load/sketch sample", detail=rfiles[0]):
            sk = _load_sample(opts, rfiles, is_sketch, genome_sketches,
                              device_engine)
        if sk is None:
            return
        with stage_timer("process sample", detail=rfiles[0],
                         items=len(genome_sketches)):
            results = process_sample(opts, sk, genome_sketches,
                                     device_engine)
        for r in results:
            print_ani_result(r, opts.pseudotax, out)
        out.flush()
        log.info("Finished %ssample %s.",
                 "paired " if len(rfiles) > 1 else "", rfiles[0])

    log.info("Serving: reading sample paths from stdin "
             "(one per line; two paths = read pair).")
    with maybe_profile(opts.profile_trace):
        # samples given up front (argv) serve first, then the requests
        for rfiles, is_sketch in ([(rf, False) for rf in read_files]
                                  + [([f], True) for f in read_sketch_files]):
            one(rfiles, is_sketch)
        for line in in_stream:
            parts = line.split()
            if not parts:
                continue
            if len(parts) > 2:
                log.error("serve: expected 1 or 2 paths per line, got %d "
                          "(%r); skipping.", len(parts), line.strip())
                continue
            is_sketch = (len(parts) == 1 and any(
                parts[0].endswith(s) for s in SAMPLE_FILE_SUFFIX_VALID))
            try:
                one(parts, is_sketch)
            except SystemExit as e:      # per-sample fatal (bad sketch)
                log.error("serve: sample %s failed (exit %s); continuing.",
                          parts[0], e.code)
            except Exception:
                log.exception("serve: sample %s failed; continuing.",
                              parts[0])
    log.info("sylph serve finished.")
    if close_out:
        out.close()
