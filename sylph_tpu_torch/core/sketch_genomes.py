"""Genome sketching: FracMinHash + duplicate elimination + spacing filter
(counterpart of sylph_tpu/core/sketch_genomes.py).

Behavioral spec: sylph src/sketch.rs:481-622. Per genome:
  1. extract (contig, end_pos, hash) for all surviving k-mers,
  2. drop ALL copies of any hash that occurs more than once,
  3. greedy spacing filter: keep a k-mer iff it is the first kept, on a new
     contig, or ends more than ``min_spacing`` bases after the last kept one;
     spacing-rejected k-mers are retained separately for profile reassignment.

Extraction runs on ``device`` (engine/device_sketch.py::
genome_survivor_positions: the B7 kernel on a CUDA device, its plain version
on the CPU), or, with ``device=None``, in the native C seeder on the host,
the oracle the device path is held to. The duplicate drop and the spacing
scan run on the host either way, so sketches are identical.
"""

import logging
from typing import List, Optional

import numpy as np
import torch

from ..io.fastx import FastxParseError, check_readable, parse_fastx
from .native_core import seed_positions_native, spacing_scan_native
from .types import GenomeSketch

log = logging.getLogger("sylph")


def _spacing_filter(contigs: np.ndarray, positions: np.ndarray,
                    hashes: np.ndarray, min_spacing: int, pseudotax: bool,
                    per_contig: bool):
    """Duplicate-hash drop + greedy spacing scan
    (sylph src/sketch.rs:590-614; individual mode :510-531).

    Inputs are in (contig, position) order, which the reference sorts to
    get and both extractions produce."""
    if hashes.size == 0:
        empty = np.empty(0, np.uint64)
        return empty, (np.empty(0, np.uint64) if pseudotax else None)
    uniq, counts = np.unique(hashes, return_counts=True)
    dup = uniq[counts > 1]
    keep_mask = ~np.isin(hashes, dup)
    h = hashes[keep_mask]
    kept, tracked = spacing_scan_native(contigs[keep_mask],
                                        positions[keep_mask], min_spacing,
                                        per_contig, pseudotax)
    return h[kept], (h[tracked] if pseudotax else None)


def _extract_positions(px, c: int, k: int,
                       device: Optional[torch.device]):
    """(contigs, end_positions, hashes) over all records, seeded on
    ``device`` or, for None, by the native C seeder."""
    if device is not None:
        from ..engine.device_sketch import genome_survivor_positions
        return genome_survivor_positions(px, c, k, device)
    return seed_positions_native(px.codes, px.starts, px.ends, c, k)


def _parse(ref_file: str):
    """The parsed file, or None for an input that cannot be opened or
    parsed (warned and skipped, src/sketch.rs:489-491). Only the open
    check and the parser's own error count as a bad input: a failure of a
    native library or a kernel reaches the caller."""
    try:
        check_readable(ref_file)
        return parse_fastx(ref_file)
    except FastxParseError:
        log.warning("%s is not a valid fasta/fastq file; skipping.", ref_file)
        return None


def sketch_genome(c: int, k: int, ref_file: str, min_spacing: int,
                  pseudotax: bool,
                  device: Optional[torch.device] = None
                  ) -> Optional[GenomeSketch]:
    """Whole-file genome sketch (sylph src/sketch.rs:550-622)."""
    px = _parse(ref_file)
    if px is None:
        return None
    contigs, positions, hashes = _extract_positions(px, c, k, device)
    kmers, tracked = _spacing_filter(contigs, positions, hashes, min_spacing,
                                     pseudotax, per_contig=False)
    return GenomeSketch(
        genome_kmers=kmers,
        pseudotax_tracked_nonused_kmers=tracked,
        file_name=ref_file,
        first_contig_name=px.names[0] if px.names else "",
        c=c, k=k,
        gn_size=int(px.lengths.sum()),
        min_spacing=min_spacing,
    )


def sketch_genome_individual(c: int, k: int, ref_file: str,
                             min_spacing: int, pseudotax: bool,
                             device: Optional[torch.device] = None
                             ) -> List[GenomeSketch]:
    """One sketch per record (sylph src/sketch.rs:481-548).

    The individual-mode spacing scan does not reset on contig change
    (single contig per sketch), condition src/sketch.rs:524."""
    px = _parse(ref_file)
    if px is None:
        return []
    all_cg, all_pos, all_h = _extract_positions(px, c, k, device)
    out = []
    for i in range(px.n_records):
        m = all_cg == i
        h, p = all_h[m], all_pos[m]
        contigs = np.zeros(h.shape[0], dtype=np.int64)
        kmers, tracked = _spacing_filter(contigs, p, h, min_spacing,
                                         pseudotax, per_contig=True)
        out.append(GenomeSketch(
            genome_kmers=kmers,
            pseudotax_tracked_nonused_kmers=tracked,
            file_name=ref_file,
            first_contig_name=px.names[i] if px.names else "",
            c=c, k=k,
            gn_size=int(px.lengths[i]),
            min_spacing=min_spacing,
        ))
    return out
