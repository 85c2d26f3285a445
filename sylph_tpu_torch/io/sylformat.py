"""bincode-1.3-compatible .syldb / .sylsp (de)serialization.

Byte-compatible with the reference's artifacts so users can mix sketches
between the two implementations:
  - .sylsp = bincode(SequencesSketch)  (sylph src/sketch.rs:360,411; field
    order src/types.rs:145-155; kmer_counts encoded as a (u64,u32) sequence
    via the custom serde adapter src/types.rs:101-143)
  - .syldb = bincode(Vec<GenomeSketch>) (src/sketch.rs:474; field order
    src/types.rs:163-173)

bincode 1.3 defaults: little-endian, fixed-width ints, usize as u64,
Vec/seq prefixed by u64 length, Option as one 0/1 byte, String as u64 len +
utf8, bool as one byte, f64 as 8 LE bytes.
"""

import struct
from typing import List, Optional

import numpy as np

from ..core.types import GenomeSketch, SequencesSketch

_KMER_COUNT_DTYPE = np.dtype([("k", "<u8"), ("v", "<u4")])


class SketchFormatError(ValueError):
    pass


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise SketchFormatError("truncated sketch file")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def string(self) -> str:
        n = self.u64()
        return self._take(n).decode("utf-8")

    def opt_string(self) -> Optional[str]:
        return self.string() if self.u8() else None

    def vec_u64(self) -> np.ndarray:
        n = self.u64()
        return np.frombuffer(self._take(8 * n), dtype="<u8").astype(np.uint64)

    def kmer_count_seq(self):
        n = self.u64()
        arr = np.frombuffer(self._take(12 * n), dtype=_KMER_COUNT_DTYPE)
        return (arr["k"].astype(np.uint64), arr["v"].astype(np.uint32))


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u8(self, v: int):
        self.parts.append(bytes([v]))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def f64(self, v: float):
        self.parts.append(struct.pack("<d", v))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u64(len(b))
        self.parts.append(b)

    def opt_string(self, s: Optional[str]):
        if s is None:
            self.u8(0)
        else:
            self.u8(1)
            self.string(s)

    def vec_u64(self, arr: np.ndarray):
        self.u64(int(arr.shape[0]))
        self.parts.append(np.ascontiguousarray(arr, dtype="<u8").tobytes())

    def kmer_count_seq(self, kmers: np.ndarray, counts: np.ndarray):
        n = int(kmers.shape[0])
        self.u64(n)
        rec = np.empty(n, dtype=_KMER_COUNT_DTYPE)
        rec["k"] = kmers
        rec["v"] = counts
        self.parts.append(rec.tobytes())

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def _read_genome_sketch(r: _Reader) -> GenomeSketch:
    genome_kmers = r.vec_u64()
    tracked = r.vec_u64() if r.u8() else None
    return GenomeSketch(
        genome_kmers=genome_kmers,
        pseudotax_tracked_nonused_kmers=tracked,
        file_name=r.string(),
        first_contig_name=r.string(),
        c=r.u64(),
        k=r.u64(),
        gn_size=r.u64(),
        min_spacing=r.u64(),
    )


def _write_genome_sketch(w: _Writer, g: GenomeSketch):
    w.vec_u64(g.genome_kmers)
    if g.pseudotax_tracked_nonused_kmers is None:
        w.u8(0)
    else:
        w.u8(1)
        w.vec_u64(g.pseudotax_tracked_nonused_kmers)
    w.string(g.file_name)
    w.string(g.first_contig_name)
    w.u64(g.c)
    w.u64(g.k)
    w.u64(g.gn_size)
    w.u64(g.min_spacing)


def read_syldb(path: str) -> List[GenomeSketch]:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    n = r.u64()
    out = [_read_genome_sketch(r) for _ in range(n)]
    if r.pos != len(r.buf):
        raise SketchFormatError(f"{path}: trailing bytes")
    return out


def read_syldb_metadata(path: str):
    """Streaming metadata-only load (mirrors the DatabaseVisitor memory fix,
    sylph src/inspect.rs:78-114): k-mer arrays are skipped, only counts and
    names are materialized."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    n = r.u64()
    metas = []
    for _ in range(n):
        n_kmers = r.u64()
        r.pos += 8 * n_kmers
        if r.u8():
            n_tracked = r.u64()
            r.pos += 8 * n_tracked
        metas.append(dict(
            genome_kmers_num=n_kmers,
            file_name=r.string(),
            first_contig_name=r.string(),
            c=r.u64(),
            k=r.u64(),
            genome_size=r.u64(),
            min_spacing=r.u64(),
        ))
    return metas


def write_syldb(path: str, sketches: List[GenomeSketch]):
    w = _Writer()
    w.u64(len(sketches))
    for g in sketches:
        _write_genome_sketch(w, g)
    with open(path, "wb") as f:
        f.write(w.getvalue())


def read_sylsp(path: str) -> SequencesSketch:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    kmers, counts = r.kmer_count_seq()
    sk = SequencesSketch(
        kmers=kmers,
        counts=counts,
        c=r.u64(),
        k=r.u64(),
        file_name=r.string(),
        sample_name=r.opt_string(),
        paired=bool(r.u8()),
        mean_read_length=r.f64(),
    )
    if r.pos != len(r.buf):
        raise SketchFormatError(f"{path}: trailing bytes")
    return sk


def write_sylsp(path: str, sk: SequencesSketch):
    w = _Writer()
    w.kmer_count_seq(sk.kmers, sk.counts)
    w.u64(sk.c)
    w.u64(sk.k)
    w.string(sk.file_name)
    w.opt_string(sk.sample_name)
    w.u8(1 if sk.paired else 0)
    w.f64(sk.mean_read_length)
    with open(path, "wb") as f:
        f.write(w.getvalue())
