"""libdeflate-backed gzip member decoding (ctypes; optional).

zlib's streaming inflate runs ~130-160 MB/s on this class of host;
libdeflate's whole-buffer decoder is 2-3x faster. A gzip file is a chain
of members; ``iter_members`` walks them with
``libdeflate_gzip_decompress_ex`` (which reports bytes consumed), so
multi-member files (standard Illumina output: concatenated gzip chunks)
decode member-at-a-time with memory bounded by the largest member.
Falls back to None when the library is missing (callers use zlib).
A copy of the JAX package's io/deflate.py.
"""

import ctypes
from typing import Optional

_LIB = None
_TRIED = False

_MAX_OUT = 8 << 30            # sanity cap for one member's output


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for name in ("libdeflate.so.0", "libdeflate.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
        lib.libdeflate_free_decompressor.argtypes = [ctypes.c_void_p]
        lib.libdeflate_gzip_decompress_ex.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)]
        lib.libdeflate_gzip_decompress_ex.restype = ctypes.c_int
        _LIB = lib
        return _LIB
    return None


def iter_members(data: bytes, est_ratio: float = 6.0):
    """Yield decompressed gzip members of ``data``, or raise ValueError.

    ``est_ratio`` sizes the first output buffer guess; on
    INSUFFICIENT_SPACE (rc=3) the buffer doubles and the member retries.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("libdeflate unavailable")
    d = lib.libdeflate_alloc_decompressor()
    if not d:
        raise MemoryError("libdeflate_alloc_decompressor")
    try:
        off = 0
        n = len(data)
        base = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
        cap = 0
        out = None
        while off < n:
            remaining = n - off
            want = max(1 << 20, int(remaining * est_ratio))
            if want > cap:
                cap = want
                out = (ctypes.c_char * cap)()
            while True:
                a_in = ctypes.c_size_t()
                a_out = ctypes.c_size_t()
                rc = lib.libdeflate_gzip_decompress_ex(
                    d, ctypes.c_void_p(base + off),
                    remaining, out, cap,
                    ctypes.byref(a_in), ctypes.byref(a_out))
                if rc == 0:
                    break
                if rc == 3 and cap < _MAX_OUT:      # INSUFFICIENT_SPACE
                    cap *= 2
                    out = (ctypes.c_char * cap)()
                    continue
                raise ValueError(f"libdeflate rc={rc}")
            # (ctypes.string_at truncates sizes past INT32_MAX)
            yield memoryview(out)[:a_out.value].tobytes()
            if a_in.value == 0:
                break
            off += a_in.value
            # tolerate zero-padding after the final member like gzip does
            while off < n and data[off] == 0:
                off += 1
    finally:
        lib.libdeflate_free_decompressor(d)
