"""``sketch`` subcommand for reads (counterpart of
sylph_tpu/engine/sketch_cmd.py).

Behavioral spec: sylph ``sketch`` (src/sketch.rs:276-479) for read inputs:
routing by extension, sample renaming, one ``<dir>/<basename>.sylsp`` per
single-end input and ``<dir>/<basename>.paired.sylsp`` per pair. Reads are
seeded on ``device`` (the GPU unless the CPU is asked for). Genome inputs
(fasta, ``-g``) raise: genome sketching is not ported yet.
"""

import logging
import os
from dataclasses import dataclass, field
from typing import List, Optional

from ..constants import DEFAULT_C, DEFAULT_FPR, DEFAULT_K, SAMPLE_FILE_SUFFIX
from ..core.sketch_reads import sketch_pair_sequences, sketch_sequences
from ..gpu.grange import resolve_device
from ..io import sylformat
from ..io.fastx import is_fasta, is_fastq

log = logging.getLogger("sylph")


@dataclass
class SketchOptions:
    """The read part of SketchArgs (sylph src/cmdline.rs:28-83)."""
    files: List[str] = field(default_factory=list)
    sample_output_dir: str = "./"
    reads: List[str] = field(default_factory=list)
    genomes: List[str] = field(default_factory=list)
    first_pair: List[str] = field(default_factory=list)
    second_pair: List[str] = field(default_factory=list)
    sample_names: Optional[List[str]] = None
    list_sample_names: Optional[str] = None
    k: int = DEFAULT_K
    c: int = DEFAULT_C
    threads: int = 3
    no_dedup: bool = False
    fpr: float = DEFAULT_FPR
    device: str = "cuda"       # where reads are seeded: "cuda" or "cpu"


def sketch(o: SketchOptions):
    from ..utils.threads import set_thread_budget
    set_thread_budget(o.threads)
    if not (o.files or o.reads or o.genomes or o.first_pair
            or o.second_pair):
        log.error("No input sequences found; see sylph sketch -h for help. "
                  "Exiting.")
        raise SystemExit(1)
    if o.fpr < 0.0 or o.fpr >= 1.0:
        log.error("Invalid FPR for sketching. Must be in [0,1).")
        raise SystemExit(1)
    read_inputs: List[str] = []
    genome_inputs: List[str] = list(o.genomes)
    for f in o.files:                     # src/sketch.rs:164-189
        if is_fastq(f):
            read_inputs.append(f)
        elif is_fasta(f):
            genome_inputs.append(f)
        else:
            log.warning("%s does not have a fasta/fastq/gzip type "
                        "extension; skipping", f)
    if genome_inputs:
        raise NotImplementedError(
            "genome sketching is not ported yet: sketch "
            f"{', '.join(genome_inputs)} with `sylph sketch` (sylph_tpu)")
    read_inputs.extend(o.reads)
    if len(o.first_pair) != len(o.second_pair):
        log.error("Different number of paired sequences. Exiting.")
        raise SystemExit(1)
    pairs = list(zip(o.first_pair, o.second_pair))

    # sample names (src/sketch.rs:260-293): pairs first, then single-end
    sample_names: Optional[List[str]] = None
    if o.list_sample_names is not None:
        with open(o.list_sample_names) as f:
            sample_names = [line.rstrip("\n") for line in f]
    elif o.sample_names is not None:
        sample_names = list(o.sample_names)
    if sample_names is not None and \
            len(sample_names) != len(pairs) + len(read_inputs):
        log.error("Sample name length is not equal to the number of reads. "
                  "Exiting")
        raise SystemExit(1)

    device = resolve_device(o.device)

    def write(name, sk, suffix):
        os.makedirs(o.sample_output_dir, exist_ok=True)
        sketch_name = name if name is not None else sk.file_name
        out = os.path.join(o.sample_output_dir,
                           os.path.basename(sketch_name) + suffix)
        sylformat.write_sylsp(out, sk)
        log.info("Sketching %s complete.", out)

    if pairs:
        log.info("Sketching paired sequences...")
    for i, (f1, f2) in enumerate(pairs):
        name = sample_names[i] if sample_names is not None else None
        sk = sketch_pair_sequences(f1, f2, o.c, o.k, name, o.no_dedup,
                                   o.fpr, device=device)
        if sk is not None:
            write(name, sk, ".paired" + SAMPLE_FILE_SUFFIX)
    if read_inputs:
        log.info("Sketching non-paired sequences...")
    for i, rf in enumerate(read_inputs):
        name = (sample_names[i + len(pairs)] if sample_names is not None
                else None)
        sk = sketch_sequences(rf, o.c, o.k, name, o.no_dedup, device=device)
        if sk is not None:
            write(name, sk, SAMPLE_FILE_SUFFIX)
    log.info("Finished.")
