"""Bucketed compare-join (counterpart of sylph_tpu/tpu/bucket_join.py).

The sample (or, in the grange engine, its slice of an index chunk) is laid
out dense per bucket (or, in the hash-tiled layout, per cell = bucket*nt +
hash sub-range) and every index slot is compared against its bucket's
sample lanes. Here live the plain fill (``_sample_to_buckets``, the plain
version of kernel B1 in bucket_fill.py), the sample-capacity rules, the
compare kernel's wrappers with their plain versions:

  join_counts          B5  [B, CI] int32 weighted counts
  join_codes           B4  [B, CI] int32 codes gid*64 + min(count, 63)
  join_codes_compact   B2  the codes, each column top-packed to CAPR rows
                           per TB-row block, plus the live count
  join_*_batched       B5b, B4b, B2b: the same for S samples' [S, B, LW]
                           cell grids against one chunk, codes tagged
                           s*G*64 (the batched grange sweep)
  bucket_join_device   B5' the fill plus B5's compare at the whole-range
                           layout of the bucket regime

which launch csrc/join.cu on a CUDA tensor and run the plain version only
for a tensor on the CPU; and the bucket regime's layout
(``build_bucketed_index``), its per-chunk counts in chunk order
(``bucket_join_counts``) and the one-shot pipeline's per-genome histograms
(``build_gid_grid``, ``bucket_join_hist``); and ``BucketEngine``, the
regime's resident chunks, serving a sample's per-slot counts (the CLI's
path) or its whole-database histogram on the device.
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _cuda
from ..utils.timing import span, spanned
from .containment import genome_hist
from .keys import HIST_H, KEY_PAD, SENT, key_hi

_MODE_COUNTS, _MODE_CODES, _MODE_COMPACT = 0, 1, 2
# csrc/join.cu's geometry
_JOIN_COLS = 128              # COLS: index columns a CTA, two a thread
_JOIN_MAX_SG = 8              # MAX_SG: samples staged together
_JOIN_SMEM_MAX = 232448       # SMEM_MAX: 227 KB of shared memory a CTA
_JOIN_LANES = 512             # lanes a ring buffer holds, at least
_JOIN_LANE_MAX = 8192         # the widest lane row taken


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


def join_counts_batched_plain(ikey, dk, dw, *, nt: int = 1,
                              tile: int = 0) -> torch.Tensor:
    """Plain version of B5b (join_counts_batched): [S, B, CI] counts of one
    index chunk against S samples' [S, B, LW] cell grids."""
    return torch.stack([_block_counts(ikey, dk[s], dw[s], nt=nt, tile=tile)
                        for s in range(dk.shape[0])])


def join_codes_batched_plain(ikey, gid, dk, dw, *, G: int, nt: int = 1,
                             tile: int = 0) -> torch.Tensor:
    """Plain version of B4b (join_codes_batched): sample-tagged codes
    s*G*64 + gid*64 + min(count, 63), SENT where dead."""
    counts = join_counts_batched_plain(ikey, dk, dw, nt=nt, tile=tile)
    live = (counts > 0) & (gid < G)
    tag = torch.arange(dk.shape[0], dtype=torch.int64,
                       device=ikey.device)[:, None, None] * (G * HIST_H)
    codes = (tag + gid.to(torch.int64) * HIST_H
             + torch.clamp(counts, max=HIST_H - 1))
    return torch.where(live, codes, SENT).to(torch.int32)


def join_codes_compact_batched_plain(ikey, gid, dk, dw, *, G: int,
                                     CAPR: int, nt: int = 1, tile: int = 0):
    """Plain version of B2b (join_codes_compact_batched): each sample's
    B4b codes, each TB-row block's columns top-packed into CAPR rows (row
    order kept, overflow dropped) -> (codes [S, B/TB*CAPR, CI], n_live
    summed over the batch)."""
    codes = join_codes_batched_plain(ikey, gid, dk, dw, G=G, nt=nt,
                                     tile=tile)
    S, B, CI = codes.shape
    TB = block_rows(B)
    c4 = codes.view(S, B // TB, TB, CI)
    live = c4 != SENT
    li = live.to(torch.int64)
    rank = torch.cumsum(li, dim=2) - li
    out = torch.full((S, B // TB, CAPR, CI), SENT, dtype=torch.int32,
                     device=codes.device)
    smp, blk, row, col = (live & (rank < CAPR)).nonzero(as_tuple=True)
    out[smp, blk, rank[smp, blk, row, col], col] = c4[smp, blk, row, col]
    return out.view(S, B // TB * CAPR, CI), li.sum()


def join_counts_plain(ikey, dk, dw, *, nt: int = 1,
                      tile: int = 0) -> torch.Tensor:
    """Plain version of B5 (join_counts)."""
    return _block_counts(ikey, dk, dw, nt=nt, tile=tile)


def join_codes_plain(ikey, gid, dk, dw, *, G: int, nt: int = 1,
                     tile: int = 0) -> torch.Tensor:
    """Plain version of B4 (join_codes): B4b at S = 1 (tag 0)."""
    return join_codes_batched_plain(ikey, gid, dk[None], dw[None], G=G,
                                    nt=nt, tile=tile)[0]


def join_codes_compact_plain(ikey, gid, dk, dw, *, G: int, CAPR: int,
                             nt: int = 1, tile: int = 0):
    """Plain version of B2 (join_codes_compact): B2b at S = 1."""
    codes, n_live = join_codes_compact_batched_plain(
        ikey, gid, dk[None], dw[None], G=G, CAPR=CAPR, nt=nt, tile=tile)
    return codes[0], n_live


# ---- kernel wrappers -------------------------------------------------------

def _check_code_space(S: int, G: int) -> None:
    """Sample-tagged int32 codes with a -1 sentinel: no tag may reach bit
    31 (sylph_tpu/tpu/grange.py:1266)."""
    if S * G * HIST_H + 1 >= 1 << 31:
        raise ValueError(f"{S} samples x {G} genomes x {HIST_H} overflow "
                         "the int32 code space")


def _check_join(ikey, gid, dk, dw, nt, tile):
    """Raise unless the chunk [B, CI], its gid grid and the [S, B, LW] cell
    grids are what join.cu takes."""
    dev = ikey.device
    _cuda.require(ikey, "ikey", torch.int64, 2, dev)
    B, CI = ikey.shape
    if gid is not None:
        _cuda.require(gid, "gid", torch.int32, 2, dev)
        if tuple(gid.shape) != (B, CI):
            raise ValueError(f"gid shape {tuple(gid.shape)} != {(B, CI)}")
    _cuda.require(dk, "dk", torch.int64, 3, dev)
    _cuda.require(dw, "dw", torch.int32, 3, dev)
    LW = dk.shape[2]
    if dk.shape[1] != B or tuple(dw.shape) != tuple(dk.shape):
        raise ValueError(f"cell grids {tuple(dk.shape)}/{tuple(dw.shape)} "
                         f"do not match index rows {B}")
    if LW < 1 or LW % max(nt, 1):
        raise ValueError(f"lane width {LW} not a multiple of nt={nt}")
    if nt > 1 and not 1 <= nt * tile <= CI:
        raise ValueError(f"tiles nt={nt} x {tile} do not fit {CI} columns")


class JoinPlan(NamedTuple):
    """One launch of csrc/join.cu: SG samples staged together (grid z =
    ``n_sample_groups``), ``lane_buf`` lanes and ``list_cap`` lane lists a
    ring buffer, ``smem`` bytes of dynamic shared memory a CTA, and
    ``n_col_groups`` CTAs of 128 columns a TB-row block."""
    SG: int
    lane_buf: int
    list_cap: int
    smem: int
    n_col_groups: int
    n_sample_groups: int


def _even(n: int) -> int:
    """Slots of a lane list of n lanes in join.cu's buffers: n rounded up
    to even (two keys a 16-byte load)."""
    return n + (n & 1)


def join_plan(S: int, CI: int, LW: int, nt: int, tile: int,
              mode: int) -> JoinPlan:
    """The launch plan of join.cu for S samples' [B, LW] cell grids
    against [B, CI] index chunks in ``nt`` tiles of ``tile`` columns: as
    many samples a group as fit 8,192 lanes a row (at most 8), two ring
    buffers of at least 512 lanes (about 13 KB of shared memory, so 16 CTAs
    of 64 threads, 32 warps, reside on a SM). Raises where the kernel
    cannot take the shapes: it loads a thread's two columns as one pair,
    so CI and (nt > 1) the tile must be even."""
    nt = max(nt, 1)
    if not 1 <= LW <= _JOIN_LANE_MAX or LW % nt or S < 1:
        raise ValueError(f"lane width {LW} (nt={nt}, S={S}) not taken by "
                         f"the compare kernel (at most {_JOIN_LANE_MAX} "
                         "lanes a row, a multiple of nt)")
    if CI % 2 or (nt > 1 and tile % 2):
        raise ValueError(f"the compare kernel takes an even column count "
                         f"and tile, not CI={CI}, tile={tile}")
    cs_p = _even(LW // nt)
    SG = min(_JOIN_MAX_SG, S, max(1, _JOIN_LANE_MAX // (nt * cs_p)))
    lane_buf = max(_JOIN_LANES, SG * nt * cs_p)
    list_cap = lane_buf // cs_p
    smem = 2 * lane_buf * 12 + 2 * list_cap * 8
    if mode == _MODE_COMPACT:
        smem += SG * _JOIN_COLS * 4
    if smem > _JOIN_SMEM_MAX:
        raise ValueError(f"the compare kernel would need {smem} bytes of "
                         f"shared memory a CTA ({LW} lanes in {nt} groups)")
    return JoinPlan(SG, lane_buf, list_cap, smem, -(-CI // _JOIN_COLS),
                    -(-S // SG))


def join_occupancy(mode: int, plan: JoinPlan) -> dict:
    """What the card reports for a launch of join.cu in ``mode`` at
    ``plan``'s shared memory (card only): registers a thread, shared memory
    a CTA (static + dynamic), threads a CTA and resident CTAs a SM."""
    return _cuda.occupancy(_cuda.library("join"), "join_occupancy",
                           ctypes.c_int(mode), ctypes.c_int64(plan.SG),
                           ctypes.c_int64(plan.smem), smem=plan.smem)


def _launch_join(mode, kname, ikey, gid, dk, dw, *, nt, tile, G=0, CAPR=0):
    """One launch of join.cu over [S, B, LW] cell grids, counted as
    ``kname`` -> (out, n_live): out [S, B, CI] (counts, codes) or
    [S, B/TB*CAPR, CI] (compact codes, with n_live the batch's 0-d int64
    live count; None otherwise)."""
    _check_join(ikey, gid, dk, dw, nt, tile)
    S, B, LW = dk.shape
    CI = ikey.shape[1]
    TB = block_rows(B)
    dev = ikey.device
    plan = join_plan(S, CI, LW, nt, tile, mode)
    if ikey.data_ptr() % 16:
        raise ValueError("the compare kernel loads index keys 16 bytes at "
                         "a time: ikey must be 16-byte aligned")
    part = None
    if mode == _MODE_COMPACT:
        out = torch.empty((S, B // TB * CAPR, CI), dtype=torch.int32,
                          device=dev)
        part = torch.empty((S, B // TB, plan.n_col_groups),
                           dtype=torch.int32, device=dev)
    else:
        out = torch.empty((S, B, CI), dtype=torch.int32, device=dev)
    lib = _cuda.library("join")
    null = ctypes.c_void_p(0)
    with torch.cuda.device(dev):
        rc = lib.join_launch(
            ctypes.c_int(mode), _cuda.ptr(ikey),
            _cuda.ptr(gid) if gid is not None else null,
            _cuda.ptr(dk), _cuda.ptr(dw),
            *(ctypes.c_int64(v) for v in (
                S, B, CI, LW, TB, max(nt, 1), tile, G, CAPR, plan.SG,
                plan.lane_buf, plan.list_cap, plan.smem)),
            _cuda.ptr(out), _cuda.ptr(part) if part is not None else null,
            _cuda.stream_ptr(ikey))
    _cuda.check(lib, rc, "join_launch")
    _cuda.count_launch(kname)
    return out, (part.sum(dtype=torch.int64) if part is not None else None)


def _join_counts(ikey, dk, dw, nt, tile, kname):
    """The count-grid launch at S = 1, shared by B5 and B5'."""
    if ikey.device.type == "cpu":
        return join_counts_plain(ikey, dk, dw, nt=nt, tile=tile)
    return _launch_join(_MODE_COUNTS, kname, ikey, None, dk[None], dw[None],
                        nt=nt, tile=tile)[0][0]


def join_counts(ikey: torch.Tensor, dk: torch.Tensor, dw: torch.Tensor, *,
                nt: int = 1, tile: int = 0) -> torch.Tensor:
    """B5: [B, CI] int32 weighted equality counts of an index chunk
    against its cell grids."""
    return _join_counts(ikey, dk, dw, nt, tile, "B5_join_counts")


def join_counts_batched(ikey: torch.Tensor, dk: torch.Tensor,
                        dw: torch.Tensor, *, nt: int = 1,
                        tile: int = 0) -> torch.Tensor:
    """B5b: [S, B, CI] int32 counts of one index chunk against S samples'
    [S, B, LW] cell grids."""
    if ikey.device.type == "cpu":
        return join_counts_batched_plain(ikey, dk, dw, nt=nt, tile=tile)
    return _launch_join(_MODE_COUNTS, "B5b_join_counts_batched", ikey, None,
                        dk, dw, nt=nt, tile=tile)[0]


def join_codes(ikey: torch.Tensor, gid: torch.Tensor, dk: torch.Tensor,
               dw: torch.Tensor, *, G: int, nt: int = 1,
               tile: int = 0) -> torch.Tensor:
    """B4: [B, CI] int32 codes gid*64 + min(count, 63), SENT where the
    count is 0 or gid >= G."""
    if ikey.device.type == "cpu":
        return join_codes_plain(ikey, gid, dk, dw, G=G, nt=nt, tile=tile)
    return _launch_join(_MODE_CODES, "B4_join_codes", ikey, gid, dk[None],
                        dw[None], nt=nt, tile=tile, G=G)[0][0]


def join_codes_batched(ikey: torch.Tensor, gid: torch.Tensor,
                       dk: torch.Tensor, dw: torch.Tensor, *, G: int,
                       nt: int = 1, tile: int = 0) -> torch.Tensor:
    """B4b: [S, B, CI] int32 sample-tagged codes s*G*64 + gid*64 +
    min(count, 63) of one index chunk against S samples' cell grids."""
    _check_code_space(dk.shape[0], G)
    if ikey.device.type == "cpu":
        return join_codes_batched_plain(ikey, gid, dk, dw, G=G, nt=nt,
                                        tile=tile)
    return _launch_join(_MODE_CODES, "B4b_join_codes_batched", ikey, gid,
                        dk, dw, nt=nt, tile=tile, G=G)[0]


def _check_capr(B: int, CAPR: int) -> None:
    TB = block_rows(B)
    if not 1 <= CAPR <= TB:
        raise ValueError(f"CAPR={CAPR} outside [1, TB={TB}]")


def join_codes_compact(ikey: torch.Tensor, gid: torch.Tensor,
                       dk: torch.Tensor, dw: torch.Tensor, *, G: int,
                       CAPR: int, nt: int = 1, tile: int = 0):
    """B2: (codes [B/TB*CAPR, CI] int32, n_live 0-d int64). Each TB-row
    block's column keeps its live codes in row order in its first CAPR
    rows; n_live counts them before the CAPR cut (conservation check)."""
    _check_capr(ikey.shape[0], CAPR)
    if ikey.device.type == "cpu":
        return join_codes_compact_plain(ikey, gid, dk, dw, G=G, CAPR=CAPR,
                                        nt=nt, tile=tile)
    out, n_live = _launch_join(_MODE_COMPACT, "B2_join_codes_compact", ikey,
                               gid, dk[None], dw[None], nt=nt, tile=tile,
                               G=G, CAPR=CAPR)
    return out[0], n_live


def join_codes_compact_batched(ikey: torch.Tensor, gid: torch.Tensor,
                               dk: torch.Tensor, dw: torch.Tensor, *,
                               G: int, CAPR: int, nt: int = 1,
                               tile: int = 0):
    """B2b: (codes [S, B/TB*CAPR, CI] int32 sample-tagged, n_live 0-d int64
    summed over the batch) — B2 for S samples' [S, B, LW] cell grids
    against one index chunk."""
    _check_capr(ikey.shape[0], CAPR)
    _check_code_space(dk.shape[0], G)
    if ikey.device.type == "cpu":
        return join_codes_compact_batched_plain(ikey, gid, dk, dw, G=G,
                                                CAPR=CAPR, nt=nt, tile=tile)
    return _launch_join(_MODE_COMPACT, "B2b_join_codes_compact_batched",
                        ikey, gid, dk, dw, nt=nt, tile=tile, G=G, CAPR=CAPR)


# ---- the whole-range bucket regime (B5') -----------------------------------

class BucketedIndex(NamedTuple):
    """One index chunk laid out dense per hash bucket, on the host or (after
    ``to``) on a device."""
    key: torch.Tensor     # [B, CI] int64, KEY_PAD-padded
    src: torch.Tensor     # [m] int64 flat [B*CI] slot of each live k-mer,
    #                       in chunk order
    width: int            # hash_hi bucket width
    n_buckets: int
    m: int                # live k-mers bucketed

    def to(self, device) -> "BucketedIndex":
        return self._replace(key=self.key.to(device), src=self.src.to(device))


def build_bucketed_index(keys: np.ndarray, c: int,
                         n_slots: Optional[int] = None,
                         target_mean: float = 64.0) -> BucketedIndex:
    """Dense bucketing of a chunk's LIVE k-mers (int64 keys, any order).

    The bucket count comes from the chunk's slot count ``n_slots``
    (default: the k-mers given), B = next power of two of n_slots /
    target_mean, as the JAX package takes it from its padded chunk, so
    width and the sample capacity ``sample_cs(t, B)`` are the JAX
    package's. The JAX package buckets its zero pads too and sends them all
    to bucket 0, whose occupancy then sets CI for the whole chunk; here
    pads are never bucketed, so CI is the exact maximum occupancy of the
    live k-mers, rounded up to 128."""
    m = int(keys.size)
    n_slots = m if n_slots is None else int(n_slots)
    thr_hi = int((((1 << 64) - 1) // max(c, 1)) >> 32)
    b_want = max(1, int(n_slots / target_mean))
    B = 1 << max(0, int(np.ceil(np.log2(b_want))))
    width = thr_hi // B + 1
    hi = (keys >> 32) & 0xFFFFFFFF
    b = np.minimum(hi // width, B - 1)
    counts = np.bincount(b, minlength=B)
    ci = max(8, int(counts.max()) if m else 0)
    CI = -(-ci // 128) * 128 if ci > 8 else 8
    out_key = np.full((B, CI), KEY_PAD, np.int64)
    order = np.argsort(b, kind="stable")
    bs = b[order]
    ranks = np.arange(m) - np.concatenate([[0], np.cumsum(counts)])[bs]
    out_key[bs, ranks] = keys[order]
    src = np.empty(m, np.int64)
    src[order] = bs * CI + ranks
    return BucketedIndex(torch.from_numpy(out_key), torch.from_numpy(src),
                         width, B, m)


def bucket_join_device(ikey: torch.Tensor, skey: torch.Tensor,
                       sw: torch.Tensor, *, width: int, B: int, CS: int,
                       base: int = 0) -> torch.Tensor:
    """B5': [B, CI] per-slot sample multiplicities of a bucketed index
    chunk (``ikey``) against a hash-sorted sample table (``skey`` int64
    with a KEY_PAD tail, ``sw`` int32 weights).

    On a CUDA tensor: B1's kernel fills the [B, CS] bucket grids and the
    compare kernel counts (``bucket_counts``). On the CPU: the plain fill
    and the plain compare."""
    from .bucket_fill import bucket_fill
    dk, dw = bucket_fill(skey, sw, base, width=width, B=B, CS=CS)
    return bucket_counts(ikey, dk, dw)


def bucket_counts(ikey: torch.Tensor, dk: torch.Tensor,
                  dw: torch.Tensor) -> torch.Tensor:
    """B5''s compare: [B, CI] int32 counts of a bucketed index chunk
    against its filled [B, CS] bucket grids (B5's kernel at nt = 1, counted
    as "B5p_bucket_join"); plain version ``join_counts_plain``."""
    return _join_counts(ikey, dk, dw, 1, 0, "B5p_bucket_join")


def bucket_join_counts(bidx: BucketedIndex, skey: torch.Tensor,
                       sw: torch.Tensor, t_real: int) -> torch.Tensor:
    """[m] int32 exact sample counts of a chunk's live k-mers, in chunk
    order, on the device ``bidx`` lies on: B5' at CS = sample_cs(t_real, B)
    (``t_real`` is the table's live entry count), then one gather."""
    grid = bucket_join_device(bidx.key, skey, sw, width=bidx.width,
                              B=bidx.n_buckets,
                              CS=sample_cs(t_real, bidx.n_buckets))
    return grid.view(-1)[bidx.src]


def build_gid_grid(bidx: BucketedIndex, gids, n_genomes: int) -> torch.Tensor:
    """[B, CI] int32 genome id of every slot of a bucketed index, on the
    device ``bidx`` lies on; slots holding no k-mer get ``n_genomes``.
    ``gids[i]`` is the genome of the i-th k-mer given to
    build_bucketed_index: ids go through the recorded slots (``src``), as
    the port buckets live k-mers only (the JAX package maps its padded
    rows through ``pos``)."""
    grid = torch.full((bidx.n_buckets * bidx.key.shape[1],), n_genomes,
                      dtype=torch.int32, device=bidx.src.device)
    grid[bidx.src] = torch.as_tensor(gids, dtype=torch.int32,
                                     device=grid.device)
    return grid.view(bidx.n_buckets, -1)


def bucket_join_hist(ikey: torch.Tensor, gid_grid: torch.Tensor,
                     skey: torch.Tensor, sw: torch.Tensor, *, width: int,
                     B: int, CS: int, n_genomes: int,
                     n_buckets: int) -> torch.Tensor:
    """[G, H] int32 per-genome multiplicity histograms through the bucketed
    join (B5' with B1 as its fill on a CUDA tensor): the per-slot counts of
    ``bucket_join_device``, clamped to H - 1, binned by the slots' genome
    ids (``build_gid_grid``); slots with an id >= G fall out."""
    return genome_hist(gid_grid, bucket_join_device(
        ikey, skey, sw, width=width, B=B, CS=CS), n_genomes, n_buckets)


# ---- the bucket regime's engine --------------------------------------------

# spare bins the histogram's pad slots spread over (``hist_device_stream``):
# atomic adds into one bin queue, and about half of a chunk's slots are pads
_PAD_BINS = 1024


def padded_slots(total: int, chunk: int) -> int:
    """Slots the merge and bucket regimes pad an index of ``total`` k-mers
    to: the next power of two (at least 1024) or the next whole number of
    ``chunk``-slot chunks, whichever is smaller."""
    m = 1024
    while m < total:
        m *= 2
    return min(m, -(-total // chunk) * chunk) if total else m


class BucketEngine:
    """The bucket regime's resident index: a host index in the CLI's order
    (genomes contiguous, as ``containment.build_host_index`` gives it,
    padded to ``padded_slots``) cut into ``chunk``-slot chunks, each laid
    out dense per hash bucket once (``build_bucketed_index``) and kept on
    ``device``, with its histogram bin bases (from ``build_gid_grid``)
    once a histogram asks for them. A chunk's live k-mers are a prefix of
    it.

    ``hist_device_stream`` gives a whole-database [G, H] histogram with
    no host round trip (the CLI's prefilter histograms); ``counts`` a
    sample table's exact [M] per-slot counts (the CLI's per-genome
    statistics). Each runs B1 then B5' per chunk.
    ``counters``: ``stream_hists`` (histogram calls), ``chunk_joins`` (B1 +
    B5' per chunk, either path) and ``refills`` (histogram calls with a
    sample capacity above the engine's own, as a caller asks after a
    non-zero probe)."""

    def __init__(self, index, c: int, *, chunk: int, device):
        self.index = index
        self.chunk = int(chunk)
        self.device = torch.device(device)
        self.n_genomes = int(index.n_genomes)
        total = int(np.asarray(index.n_kmers, np.int64).sum())
        m = index.keys.size
        self.chunks = []
        for s in range(0, m, self.chunk):
            n_live = min(max(total - s, 0), self.chunk)
            self.chunks.append(build_bucketed_index(
                index.keys[s:s + n_live], c,
                n_slots=min(self.chunk, m - s)).to(self.device))
        self._bases = (None, [])        # (H, per-chunk bin bases)
        self.counters = {"stream_hists": 0, "chunk_joins": 0, "refills": 0}

    def cs(self, t: int) -> int:
        """The sample capacity the engine gives a table of ``t`` live
        entries: ``sample_cs`` at the first chunk's bucket count."""
        return sample_cs(t, self.chunks[0].n_buckets)

    def counts(self, skey: torch.Tensor, sw: torch.Tensor,
               n: int) -> torch.Tensor:
        """[M] int32 exact counts on the device of a hash-sorted table
        (``skey`` int64 with a KEY_PAD tail, ``sw`` int32) with ``n`` live
        entries: per chunk ``bucket_join_counts``, in chunk order."""
        out = torch.zeros(self.index.keys.size, dtype=torch.int32,
                          device=self.device)
        for i, ch in enumerate(self.chunks):
            base = i * self.chunk
            out[base:base + ch.m] = bucket_join_counts(ch, skey, sw, n)
        self.counters["chunk_joins"] += len(self.chunks)
        return out

    def _bin_bases(self, H: int) -> list:
        """Each chunk's [B, CI] int32 histogram bin of a slot counted 0
        times at H bins: gid * H from the chunk's genome-id grid
        (``build_gid_grid``), or for a pad slot one of _PAD_BINS spare bins
        past the G * H real ones (slot mod _PAD_BINS). Built on the first
        call and kept, all that the histograms add to the resident index;
        a call at another H builds them again for it."""
        if self._bases[0] != H:
            G, gids, out = self.n_genomes, self.index.genome_ids, []
            self._bases = (None, [])
            for i, ch in enumerate(self.chunks):
                gid = build_gid_grid(
                    ch, gids[i * self.chunk:i * self.chunk + ch.m], G)
                spare = torch.arange(gid.numel(), dtype=torch.int32,
                                     device=gid.device).view(gid.shape)
                spare.bitwise_and_(_PAD_BINS - 1).add_(G * H)
                out.append(torch.where(gid < G, gid * H, spare))
                del gid, spare
            self._bases = (H, out)
        return self._bases[1]

    @spanned("bucket")
    def hist_device_stream(self, skey: torch.Tensor,
                           w: Optional[torch.Tensor] = None, *,
                           n_buckets: int = HIST_H,
                           cs: Optional[int] = None):
        """(hist [G, H] int32, probe 0-d int64), both on the device, of a
        sample against every chunk, with no host read but the fold's.

        ``skey`` is an occurrence stream of int64 keys (any shape and
        order, -1 pads anywhere), folded first with weights clamped at
        H - 1 (``grange.fold_stream``); or, with ``w`` given, an already
        folded table (``skey`` in uint64 order, ``w`` its weights). The
        sample capacity is ``cs`` or ``sample_cs`` of the folded length.
        Per chunk, B1 fills the sample's [B, CS] bucket grids over the
        whole hash range, B5' counts each slot, and the slots are binned
        gid * H + min(count, H - 1) into one histogram by a scatter-add of
        known size (pad slots spread over spare bins), as
        ``containment.genome_hist`` bins them, bin 0 included.

        ``probe`` counts the sample entries the fills dropped for want of
        lanes, summed over the chunks: the histogram is exact iff it is 0;
        else the caller runs the call again with a larger ``cs``."""
        from .bucket_fill import bucket_fill
        from .grange import fold_stream
        G, H = self.n_genomes, int(n_buckets)
        nb = G * H
        if nb + _PAD_BINS >= 1 << 31:
            raise ValueError(f"{G} genomes x {H} bins overflow the int32 "
                             "bin space")
        if w is None:
            skey, w = fold_stream(skey, clamp=H - 1)
        sw = w.to(torch.int32)
        t = int(skey.shape[0])
        CS = self.cs(t) if cs is None else int(cs)
        if cs is not None and CS > self.cs(t):
            self.counters["refills"] += 1
        self.counters["stream_hists"] += 1
        bases = self._bin_bases(H)
        hist = torch.zeros(nb + _PAD_BINS, dtype=torch.int64,
                           device=self.device)
        one = torch.ones((), dtype=torch.int64, device=self.device)
        hi = key_hi(skey)
        geos = [(ch.width, ch.n_buckets) for ch in self.chunks]
        n_in, filled = {}, []
        for ch, geo, base in zip(self.chunks, geos, bases):
            with span("bucket.chunk"):
                with span("bucket.fill"):
                    if geo not in n_in:
                        n_in[geo] = ((torch.div(hi, ch.width,
                                                rounding_mode="floor")
                                      < ch.n_buckets) & (sw > 0)).sum()
                    dk, dw = bucket_fill(skey, sw, 0, width=ch.width,
                                         B=ch.n_buckets, CS=CS)
                    filled.append(torch.count_nonzero(dw))
                with span("bucket.join"):
                    grid = bucket_counts(ch.key, dk, dw)
                with span("bucket.bin"):
                    seg = grid.clamp_(max=H - 1).add_(base)
                    hist.index_add_(0, seg.view(-1),
                                    one.expand(seg.numel()))
        self.counters["chunk_joins"] += len(self.chunks)
        want = torch.stack([n * geos.count(g) for g, n in n_in.items()])
        return (hist[:nb].view(G, H).to(torch.int32),
                want.sum() - torch.stack(filled).sum())
