"""Cell-grid fill (B1), code-stream repack (B3) and hash-stream repack (B8)
wrappers (counterpart of sylph_tpu/tpu/bucket_fill.py), and the read
seeding's stream condensation (counterpart of tpu/pipeline.py's
condense_stream).

The JAX package builds these from butterfly routing networks because the
TPU has no cheap scatter; the CUDA kernels (csrc/fill.cu, csrc/repack.cu)
keep the output contracts and drop the networks. On a CPU tensor each
wrapper runs its plain PyTorch version; on a CUDA tensor it launches its
kernel or raises.
"""

import ctypes

import numpy as np
import torch

from . import _cuda
from .bucket_join import _sample_to_buckets

_LANES = 256
_WPB = 8          # windows per block of the JAX kernel: output length unit


def bucket_fill(skey: torch.Tensor, sw: torch.Tensor, base: int, *,
                width: int, B: int, CS: int, nt: int = 1,
                subwidth: int = 0):
    """B1: [B*nt, CS] (int64 keys, int32 weights) cell grids of a
    HASH-SORTED sample slice (``skey`` int64, KEY_PAD tail; ``sw`` int32).

    Same contract as the plain ``_sample_to_buckets``: zero-weight,
    out-of-range and over-capacity entries are dropped. The kernel never
    drops an entry for any other reason (the Pallas fill's input-window
    drop has no counterpart here)."""
    if skey.device.type == "cpu":
        return _sample_to_buckets(skey, sw, width=width, B=B, CS=CS,
                                  base=base, nt=nt, subwidth=subwidth)
    dev = skey.device
    _cuda.require(skey, "skey", torch.int64, 1, dev)
    _cuda.require(sw, "sw", torch.int32, 1, dev)
    if sw.shape != skey.shape:
        raise ValueError(f"weights {tuple(sw.shape)} != keys "
                         f"{tuple(skey.shape)}")
    if CS < 1 or width < 1 or (nt > 1 and subwidth < 1):
        raise ValueError(f"bad geometry CS={CS} width={width} nt={nt} "
                         f"subwidth={subwidth}")
    NC = B * max(nt, 1)
    out_k = torch.empty((NC, CS), dtype=torch.int64, device=dev)
    out_w = torch.empty((NC, CS), dtype=torch.int32, device=dev)
    lib = _cuda.library("fill")
    with torch.cuda.device(dev):
        rc = lib.fill_cells(
            _cuda.ptr(skey), _cuda.ptr(sw), ctypes.c_int64(skey.shape[0]),
            ctypes.c_int64(int(base)), ctypes.c_int64(width),
            ctypes.c_int64(max(nt, 1)), ctypes.c_int64(max(subwidth, 1)),
            ctypes.c_int64(CS), ctypes.c_int64(NC), _cuda.ptr(out_k),
            _cuda.ptr(out_w), _cuda.stream_ptr(skey))
    _cuda.check(lib, rc, "fill_cells")
    _cuda.count_launch("B1_fill")
    return out_k, out_w


def _n_windows(n: int, row: int) -> int:
    """Windows after padding to whole 8-window blocks (repack1_flat)."""
    return _WPB * (-(-n // (row * _WPB)))


def repack1_flat_plain(v: torch.Tensor, *, row: int,
                       cap: int) -> torch.Tensor:
    """Plain version of B3 (int32 codes) and B8 (int64 keys): per
    ``row``-slot window, the non-pad (-1) entries in order in the first
    ``cap`` slots, overflow dropped, -1 after."""
    return repack_windows_plain(v, _n_windows(v.shape[0], row), row, cap)


def repack_windows_plain(v: torch.Tensor, nwin: int, row: int,
                         cap: int) -> torch.Tensor:
    """The function of csrc/repack.cu: the flat stream ``v`` read as
    ``nwin`` windows of ``row`` slots (slots past its end are pads), each
    window's non-pad (-1) entries in order in its first ``cap`` output
    slots, overflow dropped, -1 after -> [nwin * cap]."""
    n = v.shape[0]
    vin = torch.full((nwin * row,), -1, dtype=v.dtype, device=v.device)
    vin[:n] = v
    vin = vin.view(nwin, row)
    live = vin != -1
    li = live.to(torch.int64)
    rank = torch.cumsum(li, dim=1) - li
    out = torch.full((nwin, cap), -1, dtype=v.dtype, device=v.device)
    w, i = (live & (rank < cap)).nonzero(as_tuple=True)
    out[w, rank[w, i]] = vin[w, i]
    return out.view(-1)


repack2_flat_plain = repack1_flat_plain     # B8's plain version


def _repack(v: torch.Tensor, row: int, cap: int, dtype: torch.dtype,
            entry: str, kname: str) -> torch.Tensor:
    """Shared wrapper of B3 and B8 (one kernel template, csrc/repack.cu)."""
    if row % _LANES != 0 or cap % _LANES != 0 or cap > row:
        raise ValueError(f"row/cap must be multiples of {_LANES} with "
                         f"cap <= row (got row={row} cap={cap})")
    v = v.reshape(-1)
    if v.device.type == "cpu":
        return repack1_flat_plain(v, row=row, cap=cap)
    return launch_repack(v, _n_windows(v.shape[0], row), row, cap, dtype,
                         entry, kname)


def launch_repack(v: torch.Tensor, nwin: int, row: int, cap: int,
                  dtype: torch.dtype, entry: str, kname: str) -> torch.Tensor:
    """Launch csrc/repack.cu's kernel (C entry ``entry``, int32 or int64
    instance) over ``nwin`` windows of the CUDA stream ``v`` -> [nwin * cap],
    counted under ``kname``: B3, B8, B11 and B12."""
    _cuda.require(v, "v", dtype, 1, v.device)
    out = torch.empty(nwin * cap, dtype=dtype, device=v.device)
    lib = _cuda.library("repack")
    with torch.cuda.device(v.device):
        rc = getattr(lib, entry)(
            _cuda.ptr(v), ctypes.c_int64(v.shape[0]), ctypes.c_int64(row),
            ctypes.c_int64(cap), ctypes.c_int64(nwin), _cuda.ptr(out),
            _cuda.stream_ptr(v))
    _cuda.check(lib, rc, entry)
    _cuda.count_launch(kname)
    return out


def repack1_flat(v: torch.Tensor, *, row: int, cap: int) -> torch.Tensor:
    """B3: condense a SENT-coded int32 stream by ``row``-slot windows to
    ``cap`` slots each (the stream is SENT-padded to whole blocks of 8
    windows, as the JAX kernel's grid requires: output length is
    nwin * cap). Callers verify conservation downstream."""
    return _repack(v, row, cap, torch.int32, "repack_launch", "B3_repack")


def repack2_flat(v: torch.Tensor, *, row: int, cap: int) -> torch.Tensor:
    """B8: B3's contract on an int64 hash-key stream (pad -1), the port's
    form of the JAX package's (hi, lo) pair repack. Order is preserved:
    the stream feeds the order-dependent dedup fold."""
    return _repack(v, row, cap, torch.int64, "repack64_launch",
                   "B8_repack2")


def condense_plan(n: int, density: float):
    """(row, cap) of each repack pass that condense_stream runs over an
    n-slot stream at estimated live share ``density`` (the JAX package's
    tpu/pipeline.py:251-280 arithmetic): the widest window (1024..32768
    slots) whose capacity, expectation + 6 sigma + 16 rounded up to 256,
    stays well under its width, until the stream is 0.75 dense."""
    plan = []
    while density < 0.75 and n > 4 * 1024:
        row = 1024
        while row < 32768 and row * 2 * density < 2048 and n > 4 * row * 2:
            row *= 2
        exp = row * density
        cap = 256 * int(np.ceil((exp + 6.0 * np.sqrt(exp) + 16) / 256))
        if cap >= row:
            break
        plan.append((row, cap))
        n = _n_windows(n, row) * cap
        density = density * row / cap
    return plan


def condense_stream(keys: torch.Tensor, live_fraction: float) -> torch.Tensor:
    """Repack (B8) a sparse pad-coded int64 hash stream until it is
    reasonably dense; order is preserved. Each pass's capacity keeps a
    window's overflow probability near 1e-9; callers compare the live
    count with their own and redo losslessly on a mismatch."""
    for row, cap in condense_plan(keys.numel(), live_fraction):
        keys = repack2_flat(keys, row=row, cap=cap)
    return keys
