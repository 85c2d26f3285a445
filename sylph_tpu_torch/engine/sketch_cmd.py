"""``sketch`` subcommand (counterpart of sylph_tpu/engine/sketch_cmd.py).

Behavioral spec: sylph ``sketch`` (src/sketch.rs:276-479): routing by
extension, list files, sample renaming, one ``<dir>/<basename>.sylsp`` per
single-end read input, ``<dir>/<basename>.paired.sylsp`` per pair, and one
``<out>.syldb`` for all genomes. Reads and genomes are seeded on ``device``
(the GPU unless the CPU is asked for); the duplicate and spacing filters of
genomes and the dedup fold of reads run on the host.
"""

import logging
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..constants import (DEFAULT_C, DEFAULT_FPR, DEFAULT_K,
                         DEFAULT_MIN_SPACING, QUERY_FILE_SUFFIX,
                         SAMPLE_FILE_SUFFIX)
from ..core.sketch_genomes import sketch_genome, sketch_genome_individual
from ..core.sketch_reads import sketch_pair_sequences, sketch_sequences
from ..gpu.grange import resolve_device
from ..io import sylformat
from ..io.fastx import is_fasta, is_fastq

log = logging.getLogger("sylph")


def _vmem_gb() -> Optional[float]:
    """Current process virtual memory in GB (Linux /proc)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmSize:"):
                    return int(line.split()[1]) / (1024.0 * 1024.0)
    except OSError:
        pass
    return None


def check_ram_and_block(max_ram: Optional[int], context: str) -> None:
    """Backpressure while over the --ram-barrier budget
    (sylph check_vram_and_block, src/sketch.rs:27-51): sleep until virtual
    memory drops below the barrier, logging every ~30s."""
    if max_ram is None:
        return
    waited = 0.0
    while True:
        gb = _vmem_gb()
        if gb is None or gb < float(max_ram):
            return
        if waited % 30.0 < 1.0:
            log.info("Sketching paused before %s: virtual memory %.1f GB "
                     ">= barrier %d GB...", context, gb, max_ram)
        time.sleep(1.0)
        waited += 1.0


@dataclass
class SketchOptions:
    """SketchArgs (sylph src/cmdline.rs:28-83)."""
    files: List[str] = field(default_factory=list)
    db_out_name: str = "database"
    sample_output_dir: str = "./"
    individual: bool = False
    reads: List[str] = field(default_factory=list)
    genomes: List[str] = field(default_factory=list)
    list_sequence: Optional[str] = None
    list_reads: Optional[str] = None
    list_genomes: Optional[str] = None
    list_first_pair: Optional[str] = None
    list_second_pair: Optional[str] = None
    first_pair: List[str] = field(default_factory=list)
    second_pair: List[str] = field(default_factory=list)
    sample_names: Optional[List[str]] = None
    list_sample_names: Optional[str] = None
    k: int = DEFAULT_K
    c: int = DEFAULT_C
    threads: int = 3
    max_ram: Optional[int] = None
    no_dedup: bool = False
    no_pseudotax: bool = False
    min_spacing_kmer: int = DEFAULT_MIN_SPACING
    fpr: float = DEFAULT_FPR
    device: str = "cuda"       # where sequences are seeded: "cuda" or "cpu"


def _parse_line_file(path: str, vec: List[str]):
    with open(path) as f:
        for line in f:
            vec.append(line.rstrip("\n"))


def sketch(o: SketchOptions):
    from ..utils.threads import set_thread_budget
    set_thread_budget(o.threads)
    lists = (o.list_sequence, o.list_reads, o.list_genomes,
             o.list_first_pair, o.list_second_pair)
    if not (o.files or o.reads or o.genomes or o.first_pair
            or o.second_pair or any(x is not None for x in lists)):
        log.error("No input sequences found; see sylph sketch -h for help. "
                  "Exiting.")
        raise SystemExit(1)
    if o.fpr < 0.0 or o.fpr >= 1.0:
        log.error("Invalid FPR for sketching. Must be in [0,1).")
        raise SystemExit(1)
    read_inputs: List[str] = []
    genome_inputs: List[str] = []
    all_files: List[str] = []             # src/sketch.rs:164-189
    if o.list_sequence is not None:
        _parse_line_file(o.list_sequence, all_files)
    all_files.extend(o.files)
    for f in all_files:
        if is_fastq(f):
            read_inputs.append(f)
        elif is_fasta(f):
            genome_inputs.append(f)
        else:
            log.warning("%s does not have a fasta/fastq/gzip type "
                        "extension; skipping", f)
    genome_inputs.extend(o.genomes)       # src/sketch.rs:191-216
    read_inputs.extend(o.reads)
    if o.list_reads is not None:
        _parse_line_file(o.list_reads, read_inputs)
    if o.list_genomes is not None:
        _parse_line_file(o.list_genomes, genome_inputs)
    if len(o.first_pair) != len(o.second_pair):   # src/sketch.rs:218-250
        log.error("Different number of paired sequences. Exiting.")
        raise SystemExit(1)
    first_pairs, second_pairs = list(o.first_pair), list(o.second_pair)
    if o.list_first_pair is not None:
        _parse_line_file(o.list_first_pair, first_pairs)
    if o.list_second_pair is not None:
        _parse_line_file(o.list_second_pair, second_pairs)
    if len(first_pairs) != len(second_pairs):
        log.error("Different number of paired sequences. Exiting.")
        raise SystemExit(1)
    pairs = list(zip(first_pairs, second_pairs))

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
    if o.max_ram is not None and o.max_ram < 7:
        log.error("Max ram must be >= 7. Exiting.")
        raise SystemExit(1)
    if not genome_inputs and o.db_out_name != "database":
        log.warning("-o is set but no genomes are present. -o only applies "
                    "to genomes; see -d for reads")

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
        check_ram_and_block(o.max_ram, rf)
        name = (sample_names[i + len(pairs)] if sample_names is not None
                else None)
        sk = sketch_sequences(rf, o.c, o.k, name, o.no_dedup, device=device)
        if sk is not None:
            write(name, sk, SAMPLE_FILE_SUFFIX)
    if genome_inputs:
        _sketch_genomes(o, genome_inputs, device)
    log.info("Finished.")


def _sketch_genomes(o: SketchOptions, genome_inputs: List[str], device):
    """All genomes into one ``<db_out_name>.syldb``, in input order, over
    a pool of -t threads (src/sketch.rs:428-470); seeding runs on
    ``device``."""
    log.info("Sketching genomes...")
    out_path = o.db_out_name + QUERY_FILE_SUFFIX
    parent = os.path.dirname(out_path)
    if parent:
        os.makedirs(parent, exist_ok=True)

    def do_genome(gf):
        check_ram_and_block(o.max_ram, gf)
        if o.individual:
            return sketch_genome_individual(
                o.c, o.k, gf, o.min_spacing_kmer, not o.no_pseudotax,
                device=device)
        g = sketch_genome(o.c, o.k, gf, o.min_spacing_kmer,
                          not o.no_pseudotax, device=device)
        return [g] if g is not None else []

    all_sketches = []
    for done, batch in enumerate(_pmap(do_genome, genome_inputs, o.threads),
                                 1):
        all_sketches.extend(batch)
        if done % 100 == 0:
            log.info("%d genomes processed.", done)
    if not all_sketches:
        log.warning("No valid genomes to sketch; %s is not output",
                    out_path)
        return
    sylformat.write_syldb(out_path, all_sketches)
    log.info("Wrote all genome sketches to %s", out_path)


def _pmap(fn, items, threads: int):
    """Order-preserving map over a pool of ``threads`` workers, the
    reference's rayon par_iter over files (the parse and the native seeding
    and scan release the GIL)."""
    if threads <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=threads) as ex:
        return list(ex.map(fn, items))
