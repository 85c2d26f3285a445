"""BGZF (blocked gzip) parallel codec for the host ingest layer.

Production fastq.gz frequently arrives bgzip-compressed (the htslib BGZF
framing, SAM spec section 4.1): the file is a chain of independent gzip
members of <= 64 KiB whose total compressed size is recorded in a
``BC`` FEXTRA subfield of each member header. Member boundaries are
therefore discoverable by walking 18-byte headers alone — no inflate —
so members can decode *in parallel* on a thread pool (zlib and libdeflate
release the GIL). The reference's ingest (needletail + flate2, sylph
src/sketch.rs:780-781) inflates any gzip strictly serially; on a
multi-core host feeding an accelerator, serial inflate is the wall, and
this codec removes it for the BGZF file class.

Plain single-member gzip cannot be member-walked (deflate streams are not
skippable without decoding) and stays on the streaming-zlib path in
io/fastx.py.

The writer emits standard BGZF (64 KiB blocks, BC subfield, EOF marker):
any gzip reader — including the reference — consumes its output
transparently.

A copy of the JAX package's io/bgzf.py (less its inflate-worker environment
switch).
"""

import struct
import zlib
from typing import Iterable, List, Optional, Tuple

_MAGIC = b"\x1f\x8b\x08\x04"
_BLOCK_IN = 65280            # decompressed bytes per block (bgzip's choice)
_MAX_BLOCK = 65536           # hard cap on total block size (BSIZE is u16)
# SAM spec: 28-byte empty final block marking end-of-file
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def looks_like_bgzf(head: bytes) -> bool:
    """Cheap probe on the first >= 18 bytes of a file."""
    if len(head) < 18 or head[:4] != _MAGIC:
        return False
    xlen = struct.unpack_from("<H", head, 10)[0]
    return xlen >= 6 and _find_bsize(head, 12, 12 + min(xlen, 6)) is not None


def _find_bsize(buf, p: int, end: int) -> Optional[int]:
    """BSIZE from the FEXTRA subfields in buf[p:end] (None if absent)."""
    while p + 4 <= end:
        si1, si2 = buf[p], buf[p + 1]
        slen = struct.unpack_from("<H", buf, p + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2 and p + 6 <= end:
            return struct.unpack_from("<H", buf, p + 4)[0]
        p += 4 + slen
    return None


def scan(data) -> Optional[List[Tuple[int, int, int]]]:
    """Walk every block header: [(offset, block_len, isize)] or None.

    Strict: every member must carry the BC subfield and fit the buffer;
    anything else returns None and callers use the generic gzip paths.
    """
    n = len(data)
    out: List[Tuple[int, int, int]] = []
    off = 0
    while off < n:
        if data[off] == 0:           # zero padding after the last member
            if data[off:].count(0) == n - off:
                break
            return None
        if n - off < 18 or data[off:off + 4] != _MAGIC:
            return None
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        if off + 12 + xlen > n:
            return None
        bsize = _find_bsize(data, off + 12, off + 12 + xlen)
        if bsize is None:
            return None
        blen = bsize + 1
        if blen < 18 + 8 or off + blen > n:
            return None
        isize = struct.unpack_from("<I", data, off + blen - 4)[0]
        out.append((off, blen, isize))
        off += blen
    return out


def iter_decompressed(data, blocks: List[Tuple[int, int, int]],
                      target_bytes: int = 32 << 20,
                      workers: Optional[int] = None,
                      with_nl: bool = False):
    """Yield decompressed text chunks (in order) via parallel block inflate.

    Blocks are grouped into ~target_bytes superchunks; each superchunk
    inflates on the pool (zlib releases the GIL) with a bounded prefetch
    window, so memory stays at O(window * target_bytes) for any file size.

    ``with_nl`` yields (chunk, nl_positions, has_cr, has_blank) tuples
    instead — the newline scan runs INSIDE the pool workers (numpy
    releases the GIL), taking it off the consumer's critical path (the
    FASTQ framer otherwise pays ~0.5 s/Gbp serially).
    """
    import os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    if workers is None:
        # inflate shares cores with the parse+seed pool downstream; ~1:3
        # work ratio, so give it about half the cores, capped (and never
        # more than the CLI's -t budget)
        from ..utils.threads import cap_workers
        workers = cap_workers(max(1, min(6, (os.cpu_count() or 2) // 2)))
    groups: List[Tuple[int, int]] = []
    acc, s = 0, 0
    for i, (_off, _blen, isize) in enumerate(blocks):
        acc += isize
        if acc >= target_bytes:
            groups.append((s, i + 1))
            s, acc = i + 1, 0
    if s < len(blocks):
        groups.append((s, len(blocks)))

    mv = memoryview(data)
    from .deflate import get_lib as _dl_lib
    _dl = _dl_lib()

    def inflate_zlib(group: Tuple[int, int]) -> bytes:
        lo, hi = group
        parts = []
        for off, blen, isize in blocks[lo:hi]:
            if isize == 0:
                continue             # EOF marker / empty member
            parts.append(zlib.decompress(mv[off:off + blen],
                                         16 + zlib.MAX_WBITS, isize))
        return b"".join(parts)

    def inflate(group: Tuple[int, int]) -> bytes:
        # libdeflate, straight into one output buffer per group (no
        # per-block bytes + join copy); zlib fallback. Both release the
        # GIL, so groups inflate concurrently across the pool.
        if _dl is None or not isinstance(data, bytes):
            return inflate_zlib(group)
        import ctypes
        lo, hi = group
        total = sum(isize for _o, _b, isize in blocks[lo:hi])
        if total == 0:
            return b""
        out = bytearray(total)
        obase = ctypes.addressof((ctypes.c_char * total).from_buffer(out))
        ibase = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
        d = _dl.libdeflate_alloc_decompressor()
        if not d:
            return inflate_zlib(group)
        try:
            nout = ctypes.c_size_t()
            pos = 0
            for off, blen, isize in blocks[lo:hi]:
                if isize == 0:
                    continue
                rc = _dl.libdeflate_gzip_decompress_ex(
                    d, ibase + off, blen, obase + pos, isize,
                    None, ctypes.byref(nout))
                if rc != 0 or nout.value != isize:
                    return inflate_zlib(group)   # corrupt ISIZE: redo safe
                pos += isize
            return out          # bytearray: parse takes it zero-copy; a
                                # bytes() conversion would copy ~2 GB/Gbp
        finally:
            _dl.libdeflate_free_decompressor(d)

    def inflate_nl(group: Tuple[int, int]):
        chunk = inflate(group)
        if not chunk:
            return None
        import numpy as _np
        arr = _np.frombuffer(chunk, _np.uint8)
        nl = _np.flatnonzero(arr == 0x0A)
        has_cr = bool((arr == 0x0D).any())
        has_blank = bool(nl.size > 1 and (_np.diff(nl) == 1).any())
        return chunk, nl, has_cr, has_blank

    work = inflate_nl if with_nl else inflate
    gi = iter(groups)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = deque()
        for _ in range(workers + 2):
            g = next(gi, None)
            if g is None:
                break
            futs.append(ex.submit(work, g))
        while futs:
            chunk = futs.popleft().result()
            g = next(gi, None)
            if g is not None:
                futs.append(ex.submit(work, g))
            if chunk:
                yield chunk


def _compress_block(raw: bytes, level: int) -> bytes:
    """One BGZF member. Splits recursively in the (text never hits it)
    case where even stored-deflate overflows the 64 KiB frame."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(raw) + co.flush()
    if 18 + len(payload) + 8 > _MAX_BLOCK:
        if level != 0 and len(raw) <= _BLOCK_IN:
            return _compress_block(raw, 0) if 18 + len(raw) + 13 \
                <= _MAX_BLOCK else _split_compress(raw, level)
        return _split_compress(raw, level)
    bsize = 18 + len(payload) + 8 - 1
    header = struct.pack("<4sIBBHBBHH", _MAGIC, 0, 0, 255, 6, 66, 67, 2,
                         bsize)
    trailer = struct.pack("<II", zlib.crc32(raw), len(raw))
    return header + payload + trailer


def _split_compress(raw: bytes, level: int) -> bytes:
    h = len(raw) // 2
    return _compress_block(raw[:h], level) + _compress_block(raw[h:], level)


def write(path: str, chunks: Iterable[bytes], level: int = 1,
          workers: Optional[int] = None,
          block_in: int = _BLOCK_IN) -> int:
    """Compress a byte-chunk stream to standard BGZF at ``path``.

    Blocks compress on a thread pool in order-preserving fashion; returns
    the number of decompressed bytes written. Used by fixture generators
    and tests; gzip-compatible output (the reference reads it unchanged).
    """
    import os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    if workers is None:
        workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    total = 0

    def blocks_of(stream: Iterable[bytes]):
        carry = b""
        for chunk in stream:
            mv = memoryview(carry + chunk) if carry else memoryview(chunk)
            pos, n = 0, len(mv)
            while n - pos >= block_in:
                yield bytes(mv[pos:pos + block_in])
                pos += block_in
            carry = bytes(mv[pos:])
        if carry:
            yield carry

    with open(path, "wb") as f, \
            ThreadPoolExecutor(max_workers=workers) as ex:
        futs = deque()
        bi = blocks_of(chunks)
        active = True
        while futs or active:
            while active and len(futs) < workers + 4:
                raw = next(bi, None)
                if raw is None:
                    active = False
                    break
                total += len(raw)
                futs.append(ex.submit(_compress_block, raw, level))
            if futs:
                f.write(futs.popleft().result())
        f.write(EOF_MARKER)
    return total
