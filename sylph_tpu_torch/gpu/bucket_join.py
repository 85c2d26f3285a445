"""Bucketed compare-join pieces of the grange engine (counterpart of
sylph_tpu/tpu/bucket_join.py).

The sample slice of an index chunk is laid out dense per bucket (or, in
the hash-tiled layout, per cell = bucket*nt + hash sub-range) and every
index slot is compared against its bucket's sample lanes. Here live the
plain fill (``_sample_to_buckets``, the plain version of kernel B1 in
bucket_fill.py), the sample-capacity rules, and the compare kernel's three
wrappers with their plain versions:

  join_counts          B5  [B, CI] int32 weighted counts
  join_codes           B4  [B, CI] int32 codes gid*64 + min(count, 63)
  join_codes_compact   B2  the codes, each column top-packed to CAPR rows
                           per TB-row block, plus the live count

All three launch csrc/join.cu on a CUDA tensor and run the plain version
only for a tensor on the CPU.
"""

import ctypes

import numpy as np
import torch

from . import _cuda
from .keys import HIST_H, KEY_PAD, SENT, key_hi

_MODE_COUNTS, _MODE_CODES, _MODE_COMPACT = 0, 1, 2
_JOIN_SMEM = 98304            # csrc/join.cu SMEM_BYTES


def _cell_ids(hi: torch.Tensor, *, width: int, B: int, base: int,
              nt: int = 1, subwidth: int = 0):
    """(cell, n_cells, in_range) — elementwise high hash word -> cell.

    nt == 1: cell = bucket = (hash_hi - base) // width. nt > 1 (tiled
    layout): cell = bucket*nt + hash sub-range within the bucket. The JAX
    package relies on uint32 wrap-around to push hashes below ``base`` out
    of range; in int64 they give a negative bucket, hence 0 <= raw < B."""
    off = hi - base
    raw = torch.div(off, width, rounding_mode="floor")
    in_range = (raw >= 0) & (raw < B)
    if nt <= 1:
        return raw, B, in_range
    within = off - raw * width
    sub = torch.clamp(torch.div(within, subwidth, rounding_mode="floor"),
                      max=nt - 1)
    return raw * nt + sub, B * nt, in_range


def _sample_to_buckets(skey: torch.Tensor, sw: torch.Tensor, *, width: int,
                       B: int, CS: int, base: int = 0, nt: int = 1,
                       subwidth: int = 0):
    """Dense [B*nt, CS] (keys, weights) cell grids of a HASH-SORTED sample
    slice — the plain version of the B1 fill.

    Zero-weight and out-of-range entries are dropped; rank = live entries
    before i in the same cell run (zero-weight slots may interleave with
    live ones and must not consume capacity); entries with rank >= CS are
    dropped. Pads are KEY_PAD / 0."""
    t = skey.shape[0]
    dev = skey.device
    raw, NC, in_range = _cell_ids(key_hi(skey), width=width, B=B,
                                  base=base, nt=nt, subwidth=subwidth)
    flat = (NC + 1) * CS
    dk = torch.full((flat + 1,), KEY_PAD, dtype=torch.int64, device=dev)
    dw = torch.zeros((flat + 1,), dtype=sw.dtype, device=dev)
    if t:
        live = in_range & (sw > 0)
        b = torch.where(live, raw, NC)
        new_run = torch.ones(t, dtype=torch.bool, device=dev)
        new_run[1:] = raw[1:] != raw[:-1]
        li = live.to(torch.int64)
        cl = torch.cumsum(li, 0) - li
        start_cl = torch.cummax(torch.where(new_run, cl, -1), 0).values
        rank = cl - start_cl
        tgt = torch.where(rank < CS, b * CS + rank, NC * CS)
        dk[tgt] = skey
        dw[tgt] = sw
    return dk[:NC * CS].view(NC, CS), dw[:NC * CS].view(NC, CS)


def sample_cs(t_real: int, B: int, granularity: int = 128) -> int:
    """Sample-side bucket capacity: mean + 6 sigma, rounded up to
    ``granularity`` (compare work is linear in CS, so the grange join uses
    granularity 8)."""
    mean = max(1.0, t_real / B)
    cs = int(np.ceil(mean + 6.0 * np.sqrt(mean) + 8))
    return -(-cs // granularity) * granularity if cs > 8 else 8


def cell_cs(t_real: int, n_cells: int) -> int:
    """Per-CELL sample lane capacity for the hash-tiled layout: 4-granular
    with a +3 pad (cells are ~nt-fold finer than buckets)."""
    mean = max(0.25, t_real / n_cells)
    cs = int(np.ceil(mean + 6.0 * np.sqrt(mean) + 3))
    return max(4, -(-cs // 4) * 4)


def block_rows(B: int) -> int:
    """TB: index rows per compare block (64, or 1 when B % 64 != 0)."""
    TB = max(1, min(64, B))
    return TB if B % TB == 0 else 1


# ---- plain versions of the compare kernel ----------------------------------

def _counts_vs_lanes(a: torch.Tensor, dk: torch.Tensor,
                     dw: torch.Tensor) -> torch.Tensor:
    """All-pairs weighted equality counts: index columns [B, W] vs the
    bucket's sample lanes [B, L], one lane column at a time."""
    counts = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    for j in range(dk.shape[1]):
        counts += torch.where(a == dk[:, j:j + 1], dw[:, j:j + 1], 0)
    return counts


def _block_counts(ikey: torch.Tensor, dk: torch.Tensor, dw: torch.Tensor,
                  *, nt: int = 1, tile: int = 0) -> torch.Tensor:
    """[B, CI] per-slot sample multiplicities (plain version of B5).

    nt > 1: index columns [t*tile, (t+1)*tile) see only lane group t of
    the [B, nt*CS_T] cell grids; the trailing overflow columns see every
    lane."""
    if nt <= 1:
        return _counts_vs_lanes(ikey, dk, dw)
    CI = ikey.shape[1]
    cs_t = dk.shape[1] // nt
    parts = [_counts_vs_lanes(ikey[:, t * tile:(t + 1) * tile],
                              dk[:, t * cs_t:(t + 1) * cs_t],
                              dw[:, t * cs_t:(t + 1) * cs_t])
             for t in range(nt)]
    if CI > nt * tile:
        parts.append(_counts_vs_lanes(ikey[:, nt * tile:], dk, dw))
    return torch.cat(parts, dim=1)


def join_counts_plain(ikey, dk, dw, *, nt: int = 1,
                      tile: int = 0) -> torch.Tensor:
    """Plain version of B5 (join_counts)."""
    return _block_counts(ikey, dk, dw, nt=nt, tile=tile)


def join_codes_plain(ikey, gid, dk, dw, *, G: int, nt: int = 1,
                     tile: int = 0) -> torch.Tensor:
    """Plain version of B4 (join_codes)."""
    counts = _block_counts(ikey, dk, dw, nt=nt, tile=tile)
    live = (counts > 0) & (gid < G)
    codes = gid * HIST_H + torch.clamp(counts, max=HIST_H - 1)
    return torch.where(live, codes, SENT).to(torch.int32)


def join_codes_compact_plain(ikey, gid, dk, dw, *, G: int, CAPR: int,
                             nt: int = 1, tile: int = 0):
    """Plain version of B2 (join_codes_compact): the B4 codes, each
    TB-row block's columns top-packed into CAPR rows (row order kept,
    overflow dropped) -> (codes, n_live)."""
    codes = join_codes_plain(ikey, gid, dk, dw, G=G, nt=nt, tile=tile)
    B, CI = codes.shape
    TB = block_rows(B)
    c3 = codes.view(B // TB, TB, CI)
    live = c3 != SENT
    li = live.to(torch.int64)
    rank = torch.cumsum(li, dim=1) - li
    out = torch.full((B // TB, CAPR, CI), SENT, dtype=torch.int32,
                     device=codes.device)
    blk, row, col = (live & (rank < CAPR)).nonzero(as_tuple=True)
    out[blk, rank[blk, row, col], col] = c3[blk, row, col]
    return out.view(B // TB * CAPR, CI), li.sum()


# ---- kernel wrappers -------------------------------------------------------

def _check_join(ikey, gid, dk, dw, nt, tile):
    dev = ikey.device
    _cuda.require(ikey, "ikey", torch.int64, 2, dev)
    B, CI = ikey.shape
    if gid is not None:
        _cuda.require(gid, "gid", torch.int32, 2, dev)
        if tuple(gid.shape) != (B, CI):
            raise ValueError(f"gid shape {tuple(gid.shape)} != {(B, CI)}")
    _cuda.require(dk, "dk", torch.int64, 2, dev)
    _cuda.require(dw, "dw", torch.int32, 2, dev)
    LW = dk.shape[1]
    if dk.shape[0] != B or tuple(dw.shape) != tuple(dk.shape):
        raise ValueError(f"cell grids {tuple(dk.shape)}/{tuple(dw.shape)} "
                         f"do not match index rows {B}")
    if LW < 1 or LW % max(nt, 1):
        raise ValueError(f"lane width {LW} not a multiple of nt={nt}")
    if nt > 1 and not 1 <= nt * tile <= CI:
        raise ValueError(f"tiles nt={nt} x {tile} do not fit {CI} columns")
    if LW * 12 > _JOIN_SMEM:
        raise ValueError(f"lane width {LW} exceeds the compare kernel's "
                         f"shared-memory stage ({_JOIN_SMEM // 12} lanes)")


def _launch_join(mode, ikey, gid, dk, dw, *, TB, nt, tile, G, CAPR, out,
                 nlive_part):
    lib = _cuda.library("join")
    B, CI = ikey.shape
    null = ctypes.c_void_p(0)
    with torch.cuda.device(ikey.device):
        rc = lib.join_launch(
            ctypes.c_int(mode), _cuda.ptr(ikey),
            _cuda.ptr(gid) if gid is not None else null,
            _cuda.ptr(dk), _cuda.ptr(dw), ctypes.c_int64(B),
            ctypes.c_int64(CI), ctypes.c_int64(dk.shape[1]),
            ctypes.c_int64(TB), ctypes.c_int64(max(nt, 1)),
            ctypes.c_int64(tile), ctypes.c_int64(G), ctypes.c_int64(CAPR),
            _cuda.ptr(out),
            _cuda.ptr(nlive_part) if nlive_part is not None else null,
            _cuda.stream_ptr(ikey))
    _cuda.check(lib, rc, "join_launch")


def join_counts(ikey: torch.Tensor, dk: torch.Tensor, dw: torch.Tensor, *,
                nt: int = 1, tile: int = 0) -> torch.Tensor:
    """B5: [B, CI] int32 weighted equality counts of an index chunk
    against its cell grids."""
    if ikey.device.type == "cpu":
        return join_counts_plain(ikey, dk, dw, nt=nt, tile=tile)
    _check_join(ikey, None, dk, dw, nt, tile)
    out = torch.empty(ikey.shape, dtype=torch.int32, device=ikey.device)
    _launch_join(_MODE_COUNTS, ikey, None, dk, dw,
                 TB=block_rows(ikey.shape[0]), nt=nt, tile=tile, G=0,
                 CAPR=0, out=out, nlive_part=None)
    _cuda.count_launch("B5_join_counts")
    return out


def join_codes(ikey: torch.Tensor, gid: torch.Tensor, dk: torch.Tensor,
               dw: torch.Tensor, *, G: int, nt: int = 1,
               tile: int = 0) -> torch.Tensor:
    """B4: [B, CI] int32 codes gid*64 + min(count, 63), SENT where the
    count is 0 or gid >= G."""
    if ikey.device.type == "cpu":
        return join_codes_plain(ikey, gid, dk, dw, G=G, nt=nt, tile=tile)
    _check_join(ikey, gid, dk, dw, nt, tile)
    out = torch.empty(ikey.shape, dtype=torch.int32, device=ikey.device)
    _launch_join(_MODE_CODES, ikey, gid, dk, dw,
                 TB=block_rows(ikey.shape[0]), nt=nt, tile=tile, G=G,
                 CAPR=0, out=out, nlive_part=None)
    _cuda.count_launch("B4_join_codes")
    return out


def join_codes_compact(ikey: torch.Tensor, gid: torch.Tensor,
                       dk: torch.Tensor, dw: torch.Tensor, *, G: int,
                       CAPR: int, nt: int = 1, tile: int = 0):
    """B2: (codes [B/TB*CAPR, CI] int32, n_live 0-d int64). Each TB-row
    block's column keeps its live codes in row order in its first CAPR
    rows; n_live counts them before the CAPR cut (conservation check)."""
    B, CI = ikey.shape
    TB = block_rows(B)
    if not 1 <= CAPR <= TB:
        raise ValueError(f"CAPR={CAPR} outside [1, TB={TB}]")
    if ikey.device.type == "cpu":
        return join_codes_compact_plain(ikey, gid, dk, dw, G=G, CAPR=CAPR,
                                        nt=nt, tile=tile)
    _check_join(ikey, gid, dk, dw, nt, tile)
    out = torch.empty((B // TB * CAPR, CI), dtype=torch.int32,
                      device=ikey.device)
    ncb = -(-CI // 128)
    part = torch.empty((B // TB, ncb), dtype=torch.int32,
                       device=ikey.device)
    _launch_join(_MODE_COMPACT, ikey, gid, dk, dw, TB=TB, nt=nt, tile=tile,
                 G=G, CAPR=CAPR, out=out, nlive_part=part)
    _cuda.count_launch("B2_join_codes_compact")
    return out, part.sum(dtype=torch.int64)
