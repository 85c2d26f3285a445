"""``inspect`` subcommand: sketch-file metadata as YAML (counterpart of
sylph_tpu/engine/inspect_cmd.py; host only).

Behavioral spec: sylph src/inspect.rs. Databases are read with the
streaming metadata-only path (k-mer arrays skipped). Output follows
serde_yaml 0.9 conventions (block style, nested sequences at key
indentation, ryu-style shortest float repr, ``null`` for None).
"""

import logging
import sys
from dataclasses import dataclass, field
from typing import List, Optional, TextIO

import numpy as np

from ..constants import QUERY_FILE_SUFFIX_VALID, SAMPLE_FILE_SUFFIX_VALID
from ..io import sylformat

log = logging.getLogger("sylph")


@dataclass
class InspectOptions:
    files: List[str] = field(default_factory=list)
    out_file_name: Optional[str] = None


def _yaml_str(s: str) -> str:
    if s == "":
        return "''"
    needs_quote = (
        s.strip() != s
        or s[0] in "-?:,[]{}#&*!|>'\"%@` "
        or ": " in s or " #" in s
        or s.lower() in ("null", "true", "false", "yes", "no", "~", "on",
                         "off")
        or any(ord(ch) < 32 for ch in s)
        or s.replace(".", "").replace("-", "").replace("e", "").isdigit()
    )
    if needs_quote:
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return s


def _fmt_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (np.float32, np.float64, float)):
        # ryu-style shortest repr, at the value's own width
        x = v if isinstance(v, np.float32) else np.float64(v)
        return np.format_float_positional(x, unique=True, trim="0")
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return _yaml_str(str(v))


def _emit_seq_item(m: dict, out: TextIO, indent: int):
    """One mapping as a block-sequence item at ``indent`` levels."""
    pad = "  " * indent
    first = True
    for k, v in m.items():
        lead = pad + ("- " if first else "  ")
        first = False
        if isinstance(v, list):
            out.write(f"{lead}{k}:\n")
            for item in v:
                _emit_seq_item(item, out, indent + 1)
        else:
            out.write(f"{lead}{k}: {_fmt_scalar(v)}\n")


def _emit(docs: List[dict], out: TextIO):
    try:
        for item in docs:
            _emit_seq_item(item, out, 0)
    except BrokenPipeError:
        pass


def inspect(opts: InspectOptions):
    read_sketch_files, genome_sketch_files = [], []
    for f in opts.files:
        if any(f.endswith(s) for s in QUERY_FILE_SUFFIX_VALID):
            genome_sketch_files.append(f)
        elif any(f.endswith(s) for s in SAMPLE_FILE_SUFFIX_VALID):
            read_sketch_files.append(f)
        else:
            log.warning("%s file is not a .sylsp or .syldb file. "
                        "Skipping...", f)

    out = (open(opts.out_file_name, "w") if opts.out_file_name
           else sys.stdout)

    db_docs = []
    for f in genome_sketch_files:
        metas = sylformat.read_syldb_metadata(f)
        if not metas:
            log.warning("The database sketch `%s` is empty. Skipping...", f)
            db_docs.append(dict(database_file="", c=0, k=0,
                                min_spacing_parameter=0, genome_files=[]))
            continue
        log.info("Database file %s processed with %d genomes", f, len(metas))
        db_docs.append(dict(
            database_file=f,
            c=metas[0]["c"],
            k=metas[0]["k"],
            min_spacing_parameter=metas[0]["min_spacing"],
            genome_files=[dict(
                file_name=m["file_name"],
                genome_kmers_num=m["genome_kmers_num"],
                first_contig_name=m["first_contig_name"],
                genome_size=m["genome_size"],
            ) for m in metas],
        ))
    _emit(db_docs, out)

    seq_docs = []
    for f in read_sketch_files:
        sk = sylformat.read_sylsp(f)
        log.info("Sequence file %s processed", f)
        f32 = np.float32
        approx = (f32(sk.mean_read_length + sk.k - 1.0) / f32(
            sk.mean_read_length) * f32(sk.c) * f32(sk.n_kmers))
        seq_docs.append(dict(
            file_name=sk.file_name,
            c=sk.c,
            k=sk.k,
            num_sketched_kmers=sk.n_kmers,
            approximate_number_bases=f32(approx),
            mean_read_length=sk.mean_read_length,
            sample_name=sk.sample_name,
            paired=sk.paired,
        ))
    _emit(seq_docs, out)
    if opts.out_file_name:
        out.close()
