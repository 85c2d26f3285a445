"""Sketch data model.

Mirrors the reference's serialized contracts (sylph src/types.rs:145-204)
while storing k-mer sets as numpy arrays instead of hashmaps — the layout the
device containment kernel consumes directly.
"""

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


class AdjustKind(enum.Enum):
    LAMBDA = "lambda"
    LOW = "LOW"
    HIGH = "HIGH"


@dataclass
class AdjustStatus:
    """sylph src/types.rs:38-43."""
    kind: AdjustKind
    value: float = 0.0

    @staticmethod
    def lam(v: float) -> "AdjustStatus":
        return AdjustStatus(AdjustKind.LAMBDA, v)

    @staticmethod
    def low() -> "AdjustStatus":
        return AdjustStatus(AdjustKind.LOW)

    @staticmethod
    def high() -> "AdjustStatus":
        return AdjustStatus(AdjustKind.HIGH)


@dataclass
class SequencesSketch:
    """Read-sample sketch: k-mer hash -> multiplicity
    (sylph src/types.rs:145-161).

    kmers/counts are kept in insertion (or file) order; ``sorted_view``
    provides the sorted layout used by the containment engine.
    """
    kmers: np.ndarray           # uint64, insertion/file order
    counts: np.ndarray          # uint32, same order
    c: int
    k: int
    file_name: str
    sample_name: Optional[str] = None
    paired: bool = False
    mean_read_length: float = 0.0
    _sorted: Optional[Tuple[np.ndarray, np.ndarray]] = field(
        default=None, repr=False, compare=False)
    # the sample's streamed device-resident copy (engine/device_sketch.py
    # DeviceSampleView) when it was sketched from raw reads on a device
    _device_view: Optional[object] = field(
        default=None, repr=False, compare=False)

    def sorted_view(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._sorted is None:
            # stable, so equal keys keep file order (the JAX package's
            # threaded C radix sort gives the same order)
            order = np.argsort(self.kmers, kind="stable")
            self._sorted = (self.kmers[order], self.counts[order])
        return self._sorted

    @property
    def n_kmers(self) -> int:
        return int(self.kmers.shape[0])

    def total_counts(self) -> int:
        return int(self.counts.sum(dtype=np.uint64))


@dataclass
class GenomeSketch:
    """Genome sketch (sylph src/types.rs:163-173).

    genome_kmers keeps the reference's (contig, position) selection order;
    pseudotax_tracked_nonused_kmers holds spacing-filter rejects used by
    profile's winner-table reassignment.
    """
    genome_kmers: np.ndarray                 # uint64
    pseudotax_tracked_nonused_kmers: Optional[np.ndarray]
    file_name: str
    first_contig_name: str
    c: int
    k: int
    gn_size: int
    min_spacing: int

    def content_key(self) -> tuple:
        """Value-identity key: the reference compares GenomeSketch by value
        (derive(PartialEq), used in winner_map lookups src/contain.rs:639)."""
        return (self.file_name, self.first_contig_name, self.c, self.k,
                self.gn_size, self.min_spacing,
                self.genome_kmers.tobytes(),
                None if self.pseudotax_tracked_nonused_kmers is None
                else self.pseudotax_tracked_nonused_kmers.tobytes())


@dataclass
class AniResult:
    """Per (sample, genome) output record (sylph src/types.rs:185-204)."""
    naive_ani: float
    final_est_ani: float
    final_est_cov: float
    seq_name: str
    gn_name: str
    contig_name: str
    mean_cov: float
    median_cov: float
    containment_index: Tuple[int, int]
    lam: AdjustStatus
    ani_ci: Tuple[Optional[float], Optional[float]]
    lambda_ci: Tuple[Optional[float], Optional[float]]
    genome_sketch: GenomeSketch
    genome_index: int = -1
    rel_abund: Optional[float] = None
    seq_abund: Optional[float] = None
    kmers_lost: Optional[int] = None
