"""Library API: programmatic sketching, querying and profiling
(counterpart of sylph_tpu/api.py).

The reference is CLI-only; this module exposes the same engine to Python
callers (notebooks, pipelines) without touching the filesystem beyond the
input sequence files. Seeding and containment run on ``device``, the GPU
unless the CPU is asked for (``device="cpu"``); there is no fall-back to
the host when no GPU is found. ``device="host"`` is the host engine (the
JAX package's ``tpu=False``): the native C seeder and numpy, no GPU and no
kernel.

    import sylph_tpu_torch.api as sylph
    db = sylph.sketch_genomes(["a.fa.gz", "b.fa.gz"], c=200, k=31)
    sample = sylph.sketch_reads("reads.fq.gz")
    for row in sylph.profile(db, sample):
        print(row.genome, row.rel_abundance, row.adjusted_ani)

``Profiler(db)`` keeps the device index resident across calls.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence

from .core.sketch_genomes import sketch_genome, sketch_genome_individual
from .core.sketch_reads import sketch_pair_sequences, sketch_sequences
from .core.types import GenomeSketch, SequencesSketch
from .engine.runner import ContainOptions, engine_device, process_sample
from .io import sylformat


@dataclass
class ProfileRow:
    """One output record (the TSV row, unformatted f64 values)."""
    sample: str
    genome: str
    contig: str
    adjusted_ani: float
    naive_ani: float
    eff_cov: float
    median_cov: float
    mean_cov_geq1: float
    containment: tuple
    ani_ci: tuple
    lambda_ci: tuple
    rel_abundance: Optional[float] = None
    seq_abundance: Optional[float] = None
    kmers_reassigned: Optional[int] = None


def sketch_genomes(paths: Sequence[str], c: int = 200, k: int = 31,
                   min_spacing: int = 30, individual: bool = False,
                   enable_profiling: bool = True,
                   device="cuda") -> List[GenomeSketch]:
    """FracMinHash-sketch genome fasta files (sylph sketch -g ...), seeded
    on ``device``."""
    dev = engine_device(device)
    out: List[GenomeSketch] = []
    for p in paths:
        if individual:
            out.extend(sketch_genome_individual(c, k, p, min_spacing,
                                                enable_profiling,
                                                device=dev))
        else:
            g = sketch_genome(c, k, p, min_spacing, enable_profiling,
                              device=dev)
            if g is not None:
                out.append(g)
    return out


def sketch_reads(path: str, pair: Optional[str] = None, c: int = 200,
                 k: int = 31, dedup: bool = True,
                 device="cuda") -> Optional[SequencesSketch]:
    """Sketch a (optionally paired) read file (sylph sketch -r/-1/-2),
    seeded on ``device``."""
    dev = engine_device(device)
    if pair is not None:
        return sketch_pair_sequences(path, pair, c, k, None, not dedup,
                                     device=dev)
    return sketch_sequences(path, c, k, None, not dedup, device=dev)


def load_db(path: str) -> List[GenomeSketch]:
    return sylformat.read_syldb(path)


def save_db(path: str, db: List[GenomeSketch]) -> None:
    sylformat.write_syldb(path, db)


def load_sample(path: str) -> SequencesSketch:
    return sylformat.read_sylsp(path)


def save_sample(path: str, s: SequencesSketch) -> None:
    sylformat.write_sylsp(path, s)


def _rows(results, pseudotax: bool) -> List[ProfileRow]:
    rows = []
    for r in results:
        rows.append(ProfileRow(
            sample=r.seq_name, genome=r.gn_name, contig=r.contig_name,
            adjusted_ani=r.final_est_ani * 100.0,
            naive_ani=r.naive_ani * 100.0,
            eff_cov=r.final_est_cov, median_cov=r.median_cov,
            mean_cov_geq1=r.mean_cov, containment=r.containment_index,
            ani_ci=r.ani_ci, lambda_ci=r.lambda_ci,
            rel_abundance=r.rel_abund if pseudotax else None,
            seq_abundance=r.seq_abund if pseudotax else None,
            kmers_reassigned=r.kmers_lost if pseudotax else None))
    return rows


def _check_profiling(db: List[GenomeSketch]) -> None:
    if db and db[0].pseudotax_tracked_nonused_kmers is None:
        raise ValueError("database was sketched with profiling disabled")


def _engine(db, device):
    """The device engine of ``db`` on ``device``, or None (the host engine)
    for ``device="host"`` (sylph_tpu/api.py:125-129 with ``tpu=False``);
    asking for the GPU without one raises (the JAX package's _engine
    returns the host engine when it finds no device)."""
    dev = engine_device(device)
    if dev is None:
        return None
    from .engine.device_exec import DeviceContainment
    return DeviceContainment(db, device=dev)


def query(db: List[GenomeSketch], sample: SequencesSketch,
          min_ani: Optional[float] = None, estimate_unknown: bool = False,
          device="cuda", **opts) -> List[ProfileRow]:
    """Coverage-adjusted containment-ANI query (sylph query)."""
    o = ContainOptions(minimum_ani=min_ani,
                       estimate_unknown=estimate_unknown, **opts)
    return _rows(process_sample(o, sample, db, _engine(db, device)), False)


def profile(db: List[GenomeSketch], sample: SequencesSketch,
            min_ani: Optional[float] = None, estimate_unknown: bool = False,
            device="cuda", **opts) -> List[ProfileRow]:
    """Taxonomic profiling with winner-take-all reassignment
    (sylph profile)."""
    o = ContainOptions(minimum_ani=min_ani,
                       estimate_unknown=estimate_unknown, pseudotax=True,
                       **opts)
    _check_profiling(db)
    return _rows(process_sample(o, sample, db, _engine(db, device)), True)


class Profiler:
    """Resident-index serving handle: builds the containment index on
    ``device`` ONCE, then serves profile()/query() calls per sample against
    the warm index — the library form of ``profile --serve`` (and the
    handle for what SYLPH_TPU_CACHE_INDEX enables across one-shot contain()
    calls).

        prof = sylph.Profiler(db)
        for s in samples:
            rows = prof.profile(s)

    Without a GPU, ``Profiler(db)`` raises unless ``device="cpu"`` or
    ``device="host"`` (the host engine, nothing resident but ``db``) is
    asked for. Reference counterpart: the resident-DB chunked sample loop
    (src/contain.rs:239-256), which amortizes the database load across one
    invocation's file list; here it amortizes across calls."""

    def __init__(self, db: List[GenomeSketch], device="cuda",
                 **default_opts):
        self.db = db
        self.device = device if device == "host" else engine_device(device)
        self._engine = _engine(db, self.device)
        self._defaults = default_opts

    def _run(self, sample, pseudotax: bool, min_ani, estimate_unknown,
             opts) -> List[ProfileRow]:
        if isinstance(sample, str):
            sample = (load_sample(sample)
                      if sample.endswith((".sylsp", ".sylsample"))
                      else sketch_reads(sample, device=self.device))
            if sample is None:
                return []
        kw = dict(self._defaults)
        kw.update(opts)
        o = ContainOptions(minimum_ani=min_ani,
                           estimate_unknown=estimate_unknown,
                           pseudotax=pseudotax, **kw)
        if pseudotax:
            _check_profiling(self.db)
        return _rows(process_sample(o, sample, self.db, self._engine),
                     pseudotax)

    def profile(self, sample, min_ani: Optional[float] = None,
                estimate_unknown: bool = False,
                **opts) -> List[ProfileRow]:
        """Taxonomic profiling of one sample (path or SequencesSketch)
        against the resident database."""
        return self._run(sample, True, min_ani, estimate_unknown, opts)

    def query(self, sample, min_ani: Optional[float] = None,
              estimate_unknown: bool = False,
              **opts) -> List[ProfileRow]:
        """Containment-ANI query of one sample against the resident
        database."""
        return self._run(sample, False, min_ani, estimate_unknown, opts)
