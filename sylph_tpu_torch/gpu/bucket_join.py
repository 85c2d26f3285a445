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
(``build_gid_grid``, ``bucket_join_hist``).
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _cuda
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
