"""ctypes bridge to the native FASTX block parser (native/fastxio.c).

A trimmed copy of the JAX package's io/native.py: only the in-memory block
parser, which the streaming ingest uses. The library is built with ``cc`` at
first use into build/native/ (utils/cbuild.py); a failed build raises.
"""

import ctypes

import numpy as np

from ..utils import cbuild


class _FxResult(ctypes.Structure):
    _fields_ = [
        ("codes", ctypes.POINTER(ctypes.c_uint8)),
        ("n_codes", ctypes.c_int64),
        ("starts", ctypes.POINTER(ctypes.c_int64)),
        ("ends", ctypes.POINTER(ctypes.c_int64)),
        ("n_records", ctypes.c_int64),
        ("names", ctypes.c_char_p),
        ("names_len", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]


def _bind(lib: ctypes.CDLL) -> None:
    lib.fx_parse_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int]
    lib.fx_parse_buffer.restype = ctypes.POINTER(_FxResult)
    lib.fx_free.argtypes = [ctypes.POINTER(_FxResult)]
    lib.fx_free.restype = None


def get_lib() -> ctypes.CDLL:
    return cbuild.load("fastxio", [], _bind)


def parse_fastx_buffer_native(data, skip_names: bool = False):
    """Native parse of an in-memory decompressed block (bytes, bytearray,
    or memoryview — the BGZF framer hands over views of the inflate
    buffers without a bytes() copy) -> ParsedFastx."""
    lib = get_lib()
    n = len(data)
    if n == 0:
        ptr = None
    else:
        arr = np.frombuffer(data, np.uint8)   # zero-copy for all three
        ptr = arr.ctypes.data
    rp = lib.fx_parse_buffer(ptr, n, 1 if skip_names else 0)
    return _convert(lib, rp)


def _convert(lib, rp):
    from .fastx import FastxParseError, ParsedFastx
    if not rp:
        raise MemoryError("fx_parse allocation failure")
    try:
        r = rp.contents
        if r.error:
            raise FastxParseError(r.error.decode("utf-8", "replace"))
        n_codes = int(r.n_codes)
        n_rec = int(r.n_records)
        codes = np.ctypeslib.as_array(r.codes, shape=(n_codes,)).copy() \
            if n_codes else np.empty(0, np.uint8)
        starts = np.ctypeslib.as_array(r.starts, shape=(n_rec,)).copy() \
            if n_rec else np.empty(0, np.int64)
        ends = np.ctypeslib.as_array(r.ends, shape=(n_rec,)).copy() \
            if n_rec else np.empty(0, np.int64)
        names = []
        if r.names_len:
            blob = ctypes.string_at(r.names, int(r.names_len))
            names = blob.decode("utf-8", "replace").split("\n")[:n_rec]
        return ParsedFastx(codes, starts, ends, names)
    finally:
        lib.fx_free(rp)
