"""FASTA/FASTQ (+gzip, BGZF) streaming into flat 2-bit-code arrays.

A trimmed copy of the JAX package's io/fastx.py: the streaming ingest only
(record-aligned decompressed blocks, each parsed by the native parser,
io/native.py). The device pipeline wants reads as one contiguous 2-bit code
array plus [start, end) offsets. Format is sniffed from the first byte ('>'
fasta / '@' fastq) like needletail does in the reference (sylph
src/sketch.rs:488, 780-781); file *extensions* only drive read-vs-genome
routing (src/sketch.rs:95-121), which callers handle.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np


def is_fastq(path: str) -> bool:
    """Extension check mirroring sylph src/sketch.rs:95-107."""
    return any(path.endswith(s) for s in
               (".fq", ".fnq", ".fastq", ".fq.gz", ".fnq.gz", ".fastq.gz"))


def is_fasta(path: str) -> bool:
    """Extension check mirroring sylph src/sketch.rs:109-121."""
    return any(path.endswith(s) for s in
               (".fa", ".fna", ".fasta", ".fa.gz", ".fna.gz", ".fasta.gz"))


class FastxParseError(ValueError):
    pass


def check_readable(*paths: str) -> None:
    """FastxParseError for an input that cannot be opened. Only this check
    turns an OSError into a skipped input: one raised while the native
    libraries or the kernels build, load or launch passes through."""
    for p in paths:
        try:
            with open(p, "rb"):
                pass
        except OSError as e:
            raise FastxParseError(f"{p}: {e}") from e


@dataclass
class ParsedFastx:
    """All records of one file, flattened.

    codes: uint8 2-bit codes of every record's sequence, concatenated.
    starts/ends: int64 per-record [start, end) into ``codes``.
    names: record ids — the full header line after '>'/'@', matching
           needletail's ``record.id()``. Empty list if skip_names.
    """
    codes: np.ndarray
    starts: np.ndarray
    ends: np.ndarray
    names: List[str] = field(default_factory=list)

    @property
    def n_records(self) -> int:
        return len(self.starts)

    @property
    def lengths(self) -> np.ndarray:
        return self.ends - self.starts

    def record_codes(self, i: int) -> np.ndarray:
        return self.codes[self.starts[i]:self.ends[i]]


def _bgzf_first_text(data, blocks) -> bytes:
    """Inflate just enough leading blocks to see the first record byte."""
    import zlib
    out = b""
    for off, blen, isize in blocks[:64]:
        if not isize:
            continue
        out += zlib.decompress(data[off:off + blen],
                               16 + zlib.MAX_WBITS, isize)
        if out.strip():
            break
    return out


def stream_blocks(path: str, target_bytes: int = 64 << 20):
    """Yield decompressed record-aligned byte blocks of ~target_bytes.

    gzip decodes incrementally (multi-member files chain transparently;
    zlib releases the GIL so this can run in a producer thread); blocks
    are cut at record boundaries (groups of 4 non-blank lines for FASTQ,
    '\\n>' for FASTA). Memory stays bounded at ~target_bytes regardless
    of file size. BGZF FASTQ takes a dedicated path: parallel member
    inflate + one numpy newline pass per chunk, with blocks yielded as
    memoryviews of the inflate buffers (no concat or per-block copies —
    the generic framing's three memchr passes and two whole-stream
    copies were the decode wall at Gbp scale).
    """

    if target_bytes < (1 << 20):            # tests use tiny windows; the
        fastq_fast_path = False             # nl-framing assumes >=4 lines
    else:                                   # per chunk
        fastq_fast_path = True
    with open(path, "rb") as f:
        head = f.read(18)
    if head[:4] == b"\x1f\x8b\x08\x04":
        from . import bgzf
        if bgzf.looks_like_bgzf(head):
            with open(path, "rb") as f:
                data = f.read()
            blocks = bgzf.scan(data)
            if blocks:
                first = _bgzf_first_text(data, blocks).lstrip(b"\n\r \t")
                if fastq_fast_path and first[:1] == b"@":
                    yield from _frame_fastq_nl(bgzf.iter_decompressed(
                        data, blocks, target_bytes, with_nl=True))
                else:
                    yield from _frame_records(
                        bgzf.iter_decompressed(data, blocks,
                                               target_bytes),
                        target_bytes)
                return
    yield from _frame_records(_text_chunks_generic(path), target_bytes)


def _text_chunks_generic(path: str):
    """Decompressed (or raw) text chunks for non-BGZF files."""
    import os
    import zlib

    with open(path, "rb") as f:
            head = f.read(18)
            f.seek(0)
            if head[:2] != b"\x1f\x8b":
                while True:
                    raw = f.read(8 << 20)
                    if not raw:
                        return
                    yield raw
                return
            # gzip: libdeflate member-at-a-time when available and the
            # compressed size is modest (2-3x faster than zlib inflate;
            # multi-member Illumina-style files stay memory-bounded at one
            # member); zlib streaming for big files, whose single member
            # would need a multi-GB one-shot buffer
            if os.path.getsize(path) <= (256 << 20):
                from .deflate import get_lib as _dl_lib, iter_members
                if _dl_lib() is not None:
                    data = f.read()
                    emitted = False
                    try:
                        for member in iter_members(data):
                            yield member
                            emitted = True
                        return
                    except (ValueError, MemoryError):
                        if emitted:
                            raise FastxParseError(
                                f"{path}: corrupt gzip member")
                        f.seek(0)           # clean restart via zlib
            dec = zlib.decompressobj(16 + zlib.MAX_WBITS)
            while True:
                raw = f.read(8 << 20)
                if not raw:
                    return
                text = dec.decompress(raw)
                # multi-member gzip: chain members
                while dec.eof and dec.unused_data:
                    tail = dec.unused_data
                    dec = zlib.decompressobj(16 + zlib.MAX_WBITS)
                    text += dec.decompress(tail)
                if text:
                    yield text

def _frame_records(chunk_iter, target_bytes: int):
    """Generic record-aligned framing over a decompressed chunk stream."""
    carry = b""
    first = True
    fastq = False
    for text in chunk_iter:
        buf = carry + text if carry else text
        mv = memoryview(buf)
        n = len(buf)
        pos = 0
        if first:
            i = 0
            while i < n and buf[i] in b"\n\r \t":
                i += 1
            if i >= n:
                carry = b""
                continue
            fastq = buf[i:i + 1] == b"@"
            first = False
        # offset bookkeeping, not re-slicing: linear in total bytes even
        # when one decoded member is gigabytes
        while n - pos >= target_bytes:
            wend = min(n, pos + target_bytes)
            cut = (_record_cut_fast_fastq(buf, pos, wend)
                   if fastq and isinstance(buf, (bytes, bytearray))
                   else None)
            if cut is None:
                cut = _record_cut(np.frombuffer(mv[pos:wend], np.uint8),
                                  fastq)
            if cut == 0:            # single record longer than the window
                cut = _record_cut(np.frombuffer(mv[pos:], np.uint8),
                                  fastq)
                if cut == 0:
                    break           # need more data
            yield bytes(mv[pos:pos + cut])
            pos += cut
        carry = bytes(mv[pos:])
    if carry.strip():
        yield carry


def _frame_fastq_nl(chunk_iter):
    """Record-aligned framing for clean FASTQ chunk streams, O(1) copies.

    One numpy pass per chunk finds every newline; cuts are then pure
    arithmetic on the position array (records are 4-line groups, and the
    cumulative line count from the file start — a true boundary — is
    exact). Blocks are yielded as memoryviews of the inflate buffers: no
    carry+chunk concat, no per-block bytes() copy. A chunk containing
    '\\r', a blank line, or a failed '@' boundary check falls back to the
    exact `_record_cut` for that chunk (and the stream stays correct:
    both framers cut only at record boundaries).
    """
    carry = b""          # partial trailing record; starts at a boundary
    carry_nl = 0         # newlines inside carry
    for item in chunk_iter:
        if isinstance(item, tuple):
            # scan precomputed inside the inflate pool (bgzf with_nl)
            chunk, nl, has_cr, has_blank = item
            arr = np.frombuffer(chunk, np.uint8)
        else:
            chunk = item
            if not len(chunk):
                continue
            arr = np.frombuffer(chunk, np.uint8)
            nl = np.flatnonzero(arr == 0x0A)
            has_cr = bool((arr == 0x0D).any())
            has_blank = bool(nl.size > 1 and (np.diff(nl) == 1).any())
        if not len(chunk):
            continue
        total = carry_nl + nl.size
        # a dirty-path carry can hold blank lines or '\r', which would
        # poison the newline arithmetic — stay on the exact path then
        dirty = bool(
            has_cr or has_blank
            or carry_nl >= 4     # malformed input left >=1 whole record
            #                      of newlines in carry; j below would wrap
            or (nl.size and nl[0] == 0
                and (carry.endswith(b"\n") or not carry))
            or carry.startswith(b"\n") or b"\n\n" in carry
            or b"\r" in carry)
        cut = -1
        if not dirty and total >= 4:
            r = int(total % 4)
            j = nl.size - 1 - r
            if j < 0:
                dirty = True
        if not dirty and total >= 4:
            cut = int(nl[j]) + 1
            # the byte after a cut must start a header; when the cut is
            # flush with the chunk end, the next chunk's head validates
            if ((cut < arr.size and arr[cut] != 0x40)
                    or (not carry and arr[0] != 0x40)):
                dirty = True
        if dirty:
            buf = carry + chunk if carry else (
                chunk if isinstance(chunk, (bytes, bytearray))
                else bytes(chunk))
            ecut = _record_cut(np.frombuffer(buf, np.uint8), True)
            if ecut > 0:
                yield buf[:ecut] if isinstance(buf, bytes) \
                    else bytes(memoryview(buf)[:ecut])
            carry = bytes(memoryview(buf)[ecut:])
            carry_nl = carry.count(b"\n")
            continue
        if total < 4:        # degenerate: accumulate until a full record
            carry = carry + chunk if carry else bytes(chunk)
            carry_nl = total
            continue
        mvc = memoryview(chunk)
        if carry:
            fcut = int(nl[3 - carry_nl]) + 1
            yield carry + bytes(mvc[:fcut])
            if cut > fcut:
                yield mvc[fcut:cut]
        else:
            yield mvc[:cut]
        carry = bytes(mvc[cut:])
        carry_nl = int(total % 4)
    if carry.strip():
        yield carry


def parse_block(block: bytes, path: str, skip_names: bool = True
                ) -> ParsedFastx:
    """Parse one decompressed record-aligned block (native parser)."""
    from .native import parse_fastx_buffer_native
    return parse_fastx_buffer_native(block, skip_names)


def stream_fastx(path: str, skip_names: bool = True,
                 target_bytes: int = 64 << 20):
    """Yield ParsedFastx chunks of ~target_bytes decompressed text each.

    The streaming-ingest entry point (reference counterpart: needletail's
    record iterator, sylph src/sketch.rs:780-781, 897-913); see
    stream_blocks/parse_block, which pipelines split into stages.
    """
    for block in stream_blocks(path, target_bytes):
        yield parse_block(block, path, skip_names)


def parse_fastx(path: str, skip_names: bool = False,
                target_bytes: int = 64 << 20) -> ParsedFastx:
    """All records of one file (genome sketching): the streamed blocks
    parsed and joined, record names kept. Raises FastxParseError on
    malformed or empty input, as the JAX package's whole-file parser does."""
    parts = list(stream_fastx(path, skip_names, target_bytes))
    if not parts:
        raise FastxParseError(f"{path}: empty file")
    if len(parts) == 1:
        return parts[0]
    offs = np.cumsum([0] + [p.codes.size for p in parts[:-1]])
    return ParsedFastx(
        np.concatenate([p.codes for p in parts]),
        np.concatenate([p.starts + o for p, o in zip(parts, offs)]),
        np.concatenate([p.ends + o for p, o in zip(parts, offs)]),
        [n for p in parts for n in p.names])


def _record_cut_fast_fastq(buf: bytes, s: int, e: int):
    """Relative record-boundary cut for buf[s:e], or None to fall back.

    The exact cut (_record_cut) materializes every newline index — a full
    numpy pass per block that dominates decode at GB/s rates. For the
    overwhelmingly common clean case (no '\\r', no blank lines) the cut
    only needs the TOTAL newline count mod 4 and a backwards walk over at
    most 8 tail lines, all memchr-speed C passes. The resulting boundary
    is validated ('@' header line, '+' third line); any irregularity
    returns None and the exact scan decides."""
    if buf[s:s + 1] != b"@" or buf.find(b"\r", s, e) != -1 \
            or buf.find(b"\n\n", s, e) != -1:
        return None
    n = buf.count(b"\n", s, e)
    r = n % 4
    if n - r == 0:
        return 0
    p = e
    for _ in range(r + 1):
        p = buf.rfind(b"\n", s, p)
        if p < 0:
            return 0
    cut = p + 1                     # just past newline #(n - r)
    # validate the record preceding the cut: 4 lines, '@' then '+' third
    q = [cut - 1]                   # newline positions walking back
    for _ in range(4):
        q.append(buf.rfind(b"\n", s, q[-1]))
    hs = q[4] + 1 if q[4] >= 0 else s
    if buf[hs:hs + 1] != b"@" or buf[q[2] + 1:q[2] + 2] != b"+":
        return None
    return cut - s


def _record_cut(buf, fastq: bool) -> int:
    """Largest prefix length ending on a record boundary (0 if none).

    ``buf`` is bytes or a uint8 array; it starts at a record boundary by
    construction. FASTQ records are strict 4-line groups, counting
    NON-BLANK lines only (blank lines between records are tolerated like
    the parsers do)."""
    arr = (buf if isinstance(buf, np.ndarray)
           else np.frombuffer(buf, dtype=np.uint8))
    if fastq:
        nl = np.flatnonzero(arr == 0x0A)
        if nl.size == 0:
            return 0
        starts = np.empty_like(nl)
        starts[0] = 0
        starts[1:] = nl[:-1] + 1
        ends = nl - ((nl > starts) & (arr[np.maximum(nl - 1, 0)] == 0x0D))
        nb = np.flatnonzero(ends > starts)       # non-blank line indices
        k = (nb.size // 4) * 4
        if k == 0:
            return 0
        return int(nl[nb[k - 1]]) + 1
    # fasta: cut before the last header that starts a line
    hdr = np.flatnonzero((arr[:-1] == 0x0A) & (arr[1:] == ord(">")))
    return int(hdr[-1]) + 1 if hdr.size else 0


class _RecordBuffer:
    """Parsed-record lookahead over a block stream (for pair alignment)."""

    def __init__(self, path: str, target_bytes: int):
        self._gen = stream_fastx(path, skip_names=True,
                                 target_bytes=target_bytes)
        self._bufs = []          # [ParsedFastx, consumed_records]
        self.avail = 0
        self.eof = False

    def fill(self, want: int):
        while self.avail < want and not self.eof:
            try:
                px = next(self._gen)
            except StopIteration:
                self.eof = True
                return
            if px.n_records:
                self._bufs.append([px, 0])
                self.avail += px.n_records

    def take(self, m: int) -> ParsedFastx:
        """Pop exactly m records (m <= avail) as one ParsedFastx."""
        codes_parts, lens_parts = [], []
        got = 0
        while got < m:
            px, s = self._bufs[0]
            n = min(m - got, px.n_records - s)
            # records are contiguous in codes (parsers build them so)
            codes_parts.append(px.codes[px.starts[s]:px.ends[s + n - 1]])
            lens_parts.append(px.lengths[s:s + n])
            got += n
            if s + n == px.n_records:
                self._bufs.pop(0)
            else:
                self._bufs[0][1] = s + n
        self.avail -= m
        codes = (codes_parts[0] if len(codes_parts) == 1
                 else np.concatenate(codes_parts))
        lens = (lens_parts[0] if len(lens_parts) == 1
                else np.concatenate(lens_parts))
        ends = np.cumsum(lens)
        return ParsedFastx(codes, ends - lens, ends, [])


def stream_fastx_pairs(path1: str, path2: str,
                       target_bytes: int = 64 << 20):
    """Yield (px1, px2) chunks with EQUAL record counts, covering pairs
    [0, min(n1, n2)) — the streaming form of parsing both mate files and
    zipping records (reference loop: sylph src/sketch.rs:809-822; the
    iteration stops when either file is exhausted)."""
    b1 = _RecordBuffer(path1, target_bytes)
    b2 = _RecordBuffer(path2, target_bytes)
    while True:
        b1.fill(1)
        b2.fill(1)
        m = min(b1.avail, b2.avail)
        if m == 0:
            return
        yield b1.take(m), b2.take(m)
