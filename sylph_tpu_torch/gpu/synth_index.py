"""Device-generated synthetic GTDB-class grange index, for the benchmark
(counterpart of sylph_tpu/tpu/synth_index.py).

``python -m sylph_tpu_torch.bench --config gtdb`` needs a GTDB-R220-shaped
index: about 7e8 uniform FracMinHash k-mers over 10^5 genomes in the
grange [B, CI] bucket chunks. Building that on the host costs minutes; this
module makes the chunks on the device with torch ops from a counter-based
generator that the host replays exactly:

    value(slot)  = mm_hash64(counter ^ SALT_V)
    hash_hi      = chunk_base + bucket*width + value_hi % width
    hash_lo      = value_lo
    gid(slot)    = mm_hash64(counter ^ SALT_G)_lo % G
    count(cell)  = mean-SPREAD + mm_hash64(cell ^ SALT_C)_lo % (2*SPREAD+1)

Every quantity is a function of the global slot counter, so
``synth_plants_host`` regenerates any subset of the index (the planted
reads invert index hashes back to 31-mers) without reading it back. The
layout is build_grange_index's: hash space [0, (2^64-1)/c) cut into
n_chunks ranges of B buckets x width; flat (nt = 1) or hash-tiled (nt > 1:
nt tiles of ``tile`` columns and a shared SYNTH_OV-column overflow region).
``DupSpec`` adds duplication skew: short runs of equal hashes inside cells
and heavy-marker cells whose runs live in a CSR regenerated from SALT_HG.

Keys are int64 with pad -1, genome ids int32 with pad G (G + n_heavy in
dup mode), as the port's GRangeIndex holds them. The JAX package computes
the counters and the hash's high word in uint32 on its device and in
uint64 in the host replay; the two agree only while every counter stays
below 2^32. Here every counter is an int64, and a geometry whose counters
would pass 2^32 raises rather than wrap.
"""

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kmer.hashing import mm_hash64_np
from .containment import _bincount
from .grange import GRangeIndex, resolve_device
from .keys import HIST_H, KEY_PAD
from .seeding import _as_i64, _lsr, mm_hash64

SALT_V = np.uint64(0x9E3779B97F4A7C15)
SALT_G = np.uint64(0xC2B2AE3D27D4EB4F)
SALT_C = np.uint64(0x165667B19E3779F9)
SALT_D = np.uint64(0x27D4EB2F165667C5)   # per-cell short-run class
SALT_L = np.uint64(0x9E3779B97F4A7C55)   # heavy run length
SALT_HG = np.uint64(0xD6E8FEB86659FD93)  # heavy CSR genome ids

SYNTH_OV = 128                # overflow columns for the tiled layout

# Short-run duplication classes d in {1, 2, 4, 8, 16}: a cell's entries
# group into runs of d equal hash values. The class is picked per cell from
# hash(cell) % 1024 with cumulative thresholds putting occurrence mass
# about 1/d on each class (a zipf(2.0) occurrence profile cut at d <= 16).
DUP_T = (541, 805, 937, 1003)

_M32 = 0xFFFFFFFF
_ROWS = 4096                  # bucket rows generated at once (transients)


class DupSpec:
    """Duplication-skew parameters of the synthetic index.

    Models a strain-rich database after build_grange_index's heavy-run
    extraction: cells hold short runs (d <= 16 copies of a hash across
    genomes, DUP_T classes); every q-th cell is a heavy-marker cell of
    ``r`` marker slots (gid = G + run), each standing for an extracted run
    of lbase + hash(run) % lmod genomes whose CSR regenerates from SALT_HG.
    ``hf`` is the share of occurrence mass in the heavy CSR; q is
    calibrated from it by synth_index_device when unset."""

    def __init__(self, hf: float = 0.5, r: int = 8, lbase: int = 369,
                 lmod: int = 256, q: Optional[int] = None):
        if not (0.0 < hf < 1.0 and r >= 1 and lbase >= 1 and lmod >= 1):
            raise ValueError(f"bad DupSpec hf={hf} r={r} lbase={lbase} "
                             f"lmod={lmod}")
        self.hf = hf
        self.r = r
        self.lbase = lbase
        self.lmod = lmod
        self.q = q                       # None: calibrated from hf

    @property
    def lmean(self) -> float:
        return self.lbase + (self.lmod - 1) / 2.0


# ---- host replays (numpy, uint64) ------------------------------------------

def heavy_lengths_np(n_heavy: int, lbase: int, lmod: int) -> np.ndarray:
    """[n_heavy] CSR run lengths."""
    rr = np.arange(n_heavy, dtype=np.uint64)
    h = mm_hash64_np(rr ^ SALT_L)
    return (lbase + (h & np.uint64(_M32)) % np.uint64(lmod)).astype(np.int64)


def heavy_gids_np(rr: np.ndarray, i: np.ndarray, G: int) -> np.ndarray:
    """Genome id of CSR entry (run rr, position i)."""
    ctr = (rr.astype(np.uint64) << np.uint64(32)) | i.astype(np.uint64)
    h = mm_hash64_np(ctr ^ SALT_HG)
    return ((h & np.uint64(_M32)) % np.uint64(G)).astype(np.int32)


def synth_heavy_csr_host(n_heavy: int, G: int, lbase: int, lmod: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(heavy_gids, heavy_ptr) materialized on the host (tests and small
    scales; at GTDB scale the CSR is about 10^8 entries and stays
    virtual)."""
    lens = heavy_lengths_np(n_heavy, lbase, lmod)
    ptr = np.zeros(n_heavy + 1, np.int64)
    np.cumsum(lens, out=ptr[1:])
    rr = np.repeat(np.arange(n_heavy, dtype=np.int64), lens)
    i = np.arange(int(ptr[-1]), dtype=np.int64) - np.repeat(ptr[:-1], lens)
    return heavy_gids_np(rr, i, G), ptr


def _default_nt() -> int:
    """SYLPH_NT, or 4 (build_grange_index's auto rule at the synthetic
    index's own geometry, target_mean 1024, picks the tiled layout)."""
    env = os.environ.get("SYLPH_NT", "auto")
    return 4 if env == "auto" else int(env)


def _tgeom(B: int, CI: int, width: int, mean: float, spread: int,
           nt: int):
    """Tiled-layout geometry: per-cell mean and spread, tile width,
    per-tile overflow share, counter stride, hash sub-range width and the
    cell count's base and modulus. Cell counts are capped at tile + ovpt,
    so a bucket's overflow always fits the shared region (no spill)."""
    mean_t = mean / nt
    spread_t = max(1, int(3.5 * math.sqrt(mean_t)))
    tile = 128 * max(1, int(round(mean_t / 128 + 0.25)))
    ovpt = SYNTH_OV // nt
    stride = tile + ovpt
    subwidth = -(-width // nt)
    cbase = max(0, int(mean_t) - spread_t)
    cmod = 2 * spread_t + 1
    return mean_t, spread_t, tile, ovpt, stride, subwidth, cbase, cmod


def _geometry(G: int, KPG: int, c: int, chunk_slots: int = 1 << 25,
              target_mean: int = 1024):
    """Chunk and bucket geometry for M = G*KPG k-mers."""
    M = G * KPG
    n_chunks = max(1, -(-M // chunk_slots))
    slots = -(-M // n_chunks)                 # live slots per chunk
    B = 1 << max(0, int(math.ceil(math.log2(max(1, slots // target_mean)))))
    mean = slots / B
    spread = max(1, int(3.5 * math.sqrt(mean)))
    CI = -(-int(mean + spread) // 128) * 128  # the max count, 128-rounded
    thr_hi = int((((1 << 64) - 1) // c) >> 32)
    width = max(1, thr_hi // (n_chunks * B))  # all hashes stay below thr
    return M, n_chunks, B, CI, width, mean, spread


def _grid_kpg(G: int, KPG: int, dup: Optional[DupSpec]) -> int:
    """k-mers a genome of the grid: all of them, or in dup mode the share
    not carried by the heavy CSR."""
    if dup is None:
        return KPG
    return -(-int(G * KPG * (1.0 - dup.hf)) // G)


def _check_counters(n_chunks: int, B: int, CI: int, nt: int, stride: int,
                    width: int) -> None:
    """Raise where a counter or a hash's high word would pass 2^32, where
    the JAX package's uint32 device counters wrap and its host replay does
    not."""
    top = n_chunks * B * (nt * stride if nt > 1 else CI)
    hi = n_chunks * B * width + width
    if top > 1 << 32 or hi > 1 << 32:
        raise ValueError(
            f"synthetic index geometry passes 2^32 (counters up to {top}, "
            f"high words up to {hi}): {n_chunks} chunks of {B} buckets")


def _resolve(G: int, KPG: int, c: int, chunk_slots: int, target_mean: int,
             nt: int, dup: Optional[DupSpec]):
    """(geometry, tiled geometry or None) with the counter check."""
    geo = _geometry(G, _grid_kpg(G, KPG, dup), c, chunk_slots, target_mean)
    M, n_chunks, B, CI, width, mean, spread = geo
    tg = _tgeom(B, CI, width, mean, spread, nt) if nt > 1 else None
    _check_counters(n_chunks, B, CI, nt, tg[4] if tg else 0, width)
    return geo, tg


def _counts_np(chunk: int, B: int, mean: float, spread: int) -> np.ndarray:
    """Per-bucket live counts of one chunk (flat layout)."""
    j = np.arange(B, dtype=np.uint64) + np.uint64(chunk * B)
    r = mm_hash64_np(j ^ SALT_C).astype(np.uint64)
    base = max(0, int(mean) - spread)
    return (base + (r & np.uint64(_M32))
            % np.uint64(2 * spread + 1)).astype(np.int64)


def _slot_values_np(counter: np.ndarray, chunk: int, B: int, CI: int,
                    width: int, G: int) -> Tuple[np.ndarray, np.ndarray]:
    """(hash u64, gid) of global slot counters (flat layout)."""
    v = mm_hash64_np(counter.astype(np.uint64) ^ SALT_V)
    g = mm_hash64_np(counter.astype(np.uint64) ^ SALT_G)
    j = (counter // CI) % B                   # bucket within chunk
    base = np.uint64(chunk) * np.uint64(B) * np.uint64(width)
    hi = (base + j.astype(np.uint64) * np.uint64(width)
          + (v >> np.uint64(32)) % np.uint64(width))
    h = (hi << np.uint64(32)) | (v & np.uint64(_M32))
    gid = ((g & np.uint64(_M32)) % np.uint64(G)).astype(np.int32)
    return h, gid


def _counts_np_tiled(chunk: int, B: int, nt: int, cbase: int, cmod: int,
                     cap: int) -> np.ndarray:
    """[B*nt] per-cell live counts of one chunk."""
    gcell = np.arange(B * nt, dtype=np.uint64) + np.uint64(chunk * B * nt)
    r = mm_hash64_np(gcell ^ SALT_C).astype(np.uint64)
    ct = (cbase + (r & np.uint64(_M32)) % np.uint64(cmod))
    return np.minimum(ct, cap).astype(np.int64)


def _slot_values_np_tiled(counter: np.ndarray, *, B: int, nt: int,
                          stride: int, subwidth: int, width: int, G: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(hash u64, gid) of tiled-layout slot counters."""
    counter = counter.astype(np.uint64)
    gcell = counter // np.uint64(stride)
    t = (gcell % np.uint64(nt)).astype(np.int64)
    j = ((gcell // np.uint64(nt)) % np.uint64(B)).astype(np.int64)
    chunk = (gcell // np.uint64(B * nt)).astype(np.int64)
    span = np.maximum(1, np.minimum(subwidth, width - t * subwidth))
    v = mm_hash64_np(counter ^ SALT_V)
    g = mm_hash64_np(counter ^ SALT_G)
    hi = (chunk * (B * width) + j * width + t * subwidth
          + ((v >> np.uint64(32)).astype(np.int64) % span)).astype(
              np.uint64)
    h = (hi << np.uint64(32)) | (v & np.uint64(_M32))
    gid = ((g & np.uint64(_M32)) % np.uint64(G)).astype(np.int32)
    return h, gid


def _dup_class_np(gcell: np.ndarray) -> np.ndarray:
    """Per-cell short-run mask d-1 (d in {1, 2, 4, 8, 16})."""
    h = mm_hash64_np(gcell.astype(np.uint64) ^ SALT_D)
    u = (h & np.uint64(_M32)) % np.uint64(1024)
    cls = sum((u >= t).astype(np.int64) for t in DUP_T)
    return (1 << cls) - 1


def _counts_np_tiled_dup(chunk: int, B: int, nt: int, cbase: int,
                         cmod: int, cap: int, q: int, r: int) -> np.ndarray:
    """[B*nt] per-cell live counts, dup mode (heavy cells hold r
    markers)."""
    gcell = np.arange(B * nt, dtype=np.uint64) + np.uint64(chunk * B * nt)
    ct = _counts_np_tiled(chunk, B, nt, cbase, cmod, cap)
    return np.where((gcell % np.uint64(q)) == 0, np.int64(r), ct)


def _slot_values_np_tiled_dup(counter: np.ndarray, *, B: int, nt: int,
                              stride: int, subwidth: int, width: int,
                              G: int, q: int, r: int
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """(hash u64, gid) of dup-mode tiled slot counters: values within a
    cell group into runs of d equal hashes (the run's first slot's counter
    feeds SALT_V); heavy cells (gcell % q == 0) hold marker slots with
    gid = G + (gcell // q) * r + s_local."""
    counter = counter.astype(np.uint64)
    gcell = counter // np.uint64(stride)
    s_loc = (counter % np.uint64(stride)).astype(np.int64)
    heavy = (gcell % np.uint64(q)) == 0
    dmask = np.where(heavy, 0, _dup_class_np(gcell))
    vctr = gcell * np.uint64(stride) + (s_loc & ~dmask).astype(np.uint64)
    t = (gcell % np.uint64(nt)).astype(np.int64)
    j = ((gcell // np.uint64(nt)) % np.uint64(B)).astype(np.int64)
    chunk = (gcell // np.uint64(B * nt)).astype(np.int64)
    span = np.maximum(1, np.minimum(subwidth, width - t * subwidth))
    v = mm_hash64_np(vctr ^ SALT_V)
    g = mm_hash64_np(counter ^ SALT_G)
    hi = (chunk * (B * width) + j * width + t * subwidth
          + ((v >> np.uint64(32)).astype(np.int64) % span)).astype(
              np.uint64)
    h = (hi << np.uint64(32)) | (v & np.uint64(_M32))
    hrun = ((gcell // np.uint64(q)).astype(np.int64) * r + s_loc)
    gid = np.where(heavy, np.int64(G) + hrun,
                   ((g & np.uint64(_M32)) % np.uint64(G))
                   .astype(np.int64)).astype(np.int32)
    return h, gid


def _enum_cells_np(first: np.ndarray, n_each: np.ndarray):
    """Ragged per-cell counter enumeration: for each selected cell i,
    counters first[i] + [0, n_each[i])."""
    total = int(n_each.sum())
    starts = np.concatenate([[0], np.cumsum(n_each)[:-1]])
    r = np.arange(total, dtype=np.int64) - np.repeat(starts, n_each)
    return np.repeat(first, n_each) + r


def _keys_np(h: np.ndarray) -> np.ndarray:
    return h.astype(np.uint64).view(np.int64)


def synth_chunks_host(G: int, KPG: int, c: int = 200,
                      chunk_slots: int = 1 << 25,
                      target_mean: int = 1024,
                      nt: Optional[int] = None,
                      dup: Optional[DupSpec] = None,
                      chunks: Optional[Sequence[int]] = None):
    """Host numpy replay of the chunks (all, or the ids in ``chunks``):
    [(keys [B, CI] int64 pad -1, gids [B, CI] int32)]. Dup mode needs a
    calibrated ``dup.q`` (run synth_index_device first, or set q)."""
    if nt is None:
        nt = _default_nt()
    if dup is not None and not (nt > 1 and dup.q is not None):
        raise ValueError("dup mode needs the tiled layout and a calibrated q")
    (M, n_chunks, B, CI, width, mean, spread), tg = _resolve(
        G, KPG, c, chunk_slots, target_mean, nt, dup)
    ids = range(n_chunks) if chunks is None else chunks
    if nt > 1:
        return [_chunk_host_tiled(i, G, n_chunks, B, width, nt, tg, dup)
                for i in ids]
    out = []
    for i in ids:
        cnt = _counts_np(i, B, mean, spread)
        j = np.repeat(np.arange(B, dtype=np.int64), CI)
        s = np.tile(np.arange(CI, dtype=np.int64), B)
        counter = (np.int64(i * B) + j) * CI + s
        h, gid = _slot_values_np(counter, i, B, CI, width, G)
        live = s < cnt[j]
        keys = np.where(live, _keys_np(h), np.int64(KEY_PAD))
        g = np.where(live, gid, np.int32(G))
        out.append((keys.reshape(B, CI), g.reshape(B, CI).astype(np.int32)))
    return out


def _chunk_host_tiled(i, G, n_chunks, B, width, nt, tg, dup=None):
    """Host numpy replay of one tiled chunk (dup mode too)."""
    _mt, _st, tile, ovpt, stride, subw, cbase, cmod = tg
    CI = nt * tile + SYNTH_OV
    n_heavy = (-(-(n_chunks * B * nt) // dup.q) * dup.r
               if dup is not None else 0)
    if dup is not None:
        cts = _counts_np_tiled_dup(i, B, nt, cbase, cmod, stride,
                                   dup.q, dup.r).reshape(B, nt)
    else:
        cts = _counts_np_tiled(i, B, nt, cbase, cmod, stride).reshape(B, nt)
    hk = np.full((B, CI), KEY_PAD, np.int64)
    hg = np.full((B, CI), np.int32(G + n_heavy), np.int32)
    nct = cts.reshape(-1)
    first = ((np.arange(B * nt, dtype=np.int64) + np.int64(i) * B * nt)
             * stride)
    counters = _enum_cells_np(first, nct)
    if dup is not None:
        h, gid = _slot_values_np_tiled_dup(
            counters, B=B, nt=nt, stride=stride, subwidth=subw,
            width=width, G=G, q=dup.q, r=dup.r)
    else:
        h, gid = _slot_values_np_tiled(counters, B=B, nt=nt, stride=stride,
                                       subwidth=subw, width=width, G=G)
    # columns: tile part at t*tile + s; overflow packed per bucket
    cell = (counters // stride).astype(np.int64) - np.int64(i) * B * nt
    s_loc = (counters % stride).astype(np.int64)
    j = cell // nt
    t = cell % nt
    in_tile = s_loc < tile
    col = np.where(in_tile, t * tile + s_loc, 0)
    ots = np.maximum(cts - tile, 0)
    cums = np.concatenate([np.zeros((B, 1), np.int64),
                           np.cumsum(ots, axis=1)], axis=1)
    ovf = ~in_tile
    col[ovf] = nt * tile + cums[j[ovf], t[ovf]] + (s_loc[ovf] - tile)
    hk[j, col] = _keys_np(h)
    hg[j, col] = gid
    return hk, hg


# ---- device generators (torch, int64) --------------------------------------

def _mix(x: torch.Tensor, salt) -> torch.Tensor:
    """mm_hash64(x ^ salt) of non-negative int64 counters (bit patterns)."""
    return mm_hash64(x ^ _as_i64(int(salt)))


def _lo(h: torch.Tensor) -> torch.Tensor:
    return h & _M32


def _key(hi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(hi << 32) | low word of v, hi < 2^32: the int64 key bits."""
    return (hi << 32) | _lo(v)


def _gen_rows_flat(chunk: int, r0: int, r1: int, *, B: int, CI: int,
                   width: int, G: int, cbase: int, cmod: int, dev):
    """Rows [r0, r1) of a flat chunk: (keys int64, gids int32)."""
    j = torch.arange(r0, r1, dtype=torch.int64, device=dev)[:, None]
    s = torch.arange(CI, dtype=torch.int64, device=dev)[None, :]
    jg = j + chunk * B                        # global bucket id
    counter = jg * CI + s                     # global slot id
    v = _mix(counter, SALT_V)
    g = _lo(_mix(counter, SALT_G))
    del counter
    cnt = cbase + _lo(_mix(jg, SALT_C)) % cmod
    live = s < cnt
    hi = chunk * (B * width) + j * width + _lsr(v, 32) % width
    keys = torch.where(live, _key(hi, v), KEY_PAD)
    gid = torch.where(live, g % G, G).to(torch.int32)
    return keys, gid


def _cell_tables(jg: torch.Tensor, *, nt: int, stride: int, tile: int,
                 cbase: int, cmod: int, dup: Optional[DupSpec]):
    """[R, nt] per-cell counts and short-run masks, and [R, nt+1] overflow
    offsets, of the rows' buckets (global bucket ids jg [R, 1])."""
    t = torch.arange(nt, dtype=torch.int64, device=jg.device)[None, :]
    gcell = jg * nt + t
    ct = torch.clamp(cbase + _lo(_mix(gcell, SALT_C)) % cmod, max=stride)
    dmask = torch.zeros_like(ct)
    if dup is not None:
        heavy = gcell % dup.q == 0
        ct = torch.where(heavy, dup.r, ct)
        u = _lo(_mix(gcell, SALT_D)) % 1024
        cls = sum((u >= th).to(torch.int64) for th in DUP_T)
        dmask = torch.where(heavy, 0, (1 << cls) - 1)
    ots = torch.clamp(ct - tile, min=0)
    cums = torch.cat([torch.zeros_like(ots[:, :1]),
                      torch.cumsum(ots, dim=1)], dim=1)
    return ct, dmask, cums


def _gen_rows_tiled(chunk: int, r0: int, r1: int, *, B: int, CI: int,
                    width: int, G: int, nt: int, tile: int, ovpt: int,
                    cbase: int, cmod: int, subwidth: int,
                    dup: Optional[DupSpec], n_heavy: int, dev):
    """Rows [r0, r1) of a hash-tiled chunk: columns [t*tile, (t+1)*tile)
    hold sub-range t's first ``tile`` entries, the trailing SYNTH_OV
    columns each bucket's overflow (entries tile.. of each over-full cell,
    in tile order). Dup mode: short runs inside cells (d equal hash values
    with distinct gids) and heavy-marker cells every q-th cell; the pad gid
    is G + n_heavy (g_eff, as build_grange_index pads)."""
    stride = tile + ovpt
    j = torch.arange(r0, r1, dtype=torch.int64, device=dev)[:, None]
    s = torch.arange(CI, dtype=torch.int64, device=dev)[None, :]
    jg = j + chunk * B
    ct, dmask, cums = _cell_tables(jg, nt=nt, stride=stride, tile=tile,
                                   cbase=cbase, cmod=cmod, dup=dup)
    R = r1 - r0
    in_tiles = s < nt * tile
    t_of_s = torch.clamp(s // tile, max=nt - 1)
    ct_sel = ct.gather(1, t_of_s.expand(R, CI))
    live_tile = in_tiles & (s % tile < torch.clamp(ct_sel, max=tile))
    del ct_sel
    k = s - nt * tile
    tau = torch.zeros((R, CI), dtype=torch.int64, device=dev)
    for t in range(1, nt):
        tau += (k >= cums[:, t:t + 1]).to(torch.int64)
    cum_tau = cums.gather(1, tau)
    live = live_tile | (~in_tiles & (k < cums[:, nt:nt + 1]))
    del live_tile
    tt = torch.where(in_tiles, t_of_s, tau)
    s_local = torch.where(in_tiles, s % tile, tile + (k - cum_tau))
    del tau, cum_tau
    gcell = jg * nt + tt
    counter = gcell * stride + s_local
    if dup is not None:
        vctr = gcell * stride + (s_local & ~dmask.gather(1, tt))
        v = _mix(vctr, SALT_V)
        del vctr
    else:
        v = _mix(counter, SALT_V)
    g = _lo(_mix(counter, SALT_G)) % G
    del counter
    span = torch.clamp(torch.clamp(width - tt * subwidth, max=subwidth),
                       min=1)
    hi = (chunk * (B * width) + j * width + tt * subwidth
          + _lsr(v, 32) % span)
    keys = torch.where(live, _key(hi, v), KEY_PAD)
    del hi, span
    if dup is not None:
        heavy = gcell % dup.q == 0
        g = torch.where(heavy, G + (gcell // dup.q) * dup.r + s_local, g)
    gid = torch.where(live, g, G + n_heavy).to(torch.int32)
    return keys, gid


def _chunk_device(chunk: int, *, B: int, CI: int, width: int, G: int,
                  mean: float, spread: int, device, nt: int = 1,
                  tg=None, dup=None, n_heavy: int = 0):
    """One chunk (keys [B, CI] int64, gids [B, CI] int32) made on
    ``device``, in blocks of _ROWS bucket rows (a block's int64
    transients, not a whole chunk's, share the device with the index)."""
    dev = torch.device(device)
    keys = torch.empty((B, CI), dtype=torch.int64, device=dev)
    gids = torch.empty((B, CI), dtype=torch.int32, device=dev)
    for r0 in range(0, B, _ROWS):
        r1 = min(B, r0 + _ROWS)
        if nt > 1:
            _mt, _st, tile, ovpt, _stride, subw, cbase, cmod = tg
            k, g = _gen_rows_tiled(
                chunk, r0, r1, B=B, CI=CI, width=width, G=G, nt=nt,
                tile=tile, ovpt=ovpt, cbase=cbase, cmod=cmod,
                subwidth=subw, dup=dup, n_heavy=n_heavy, dev=dev)
        else:
            k, g = _gen_rows_flat(chunk, r0, r1, B=B, CI=CI, width=width,
                                  G=G, cbase=max(0, int(mean) - spread),
                                  cmod=2 * spread + 1, dev=dev)
        keys[r0:r1] = k
        gids[r0:r1] = g
        del k, g
    return keys, gids


def synth_index_device(G: int, KPG: int, c: int = 200, device="cuda",
                       chunk_slots: int = 1 << 25,
                       target_mean: int = 1024,
                       nt: Optional[int] = None,
                       dup: Optional[DupSpec] = None,
                       csr_host: bool = False) -> GRangeIndex:
    """The port's GRangeIndex whose chunk grids are made on ``device``;
    GRangeEngine moves nothing it is handed on its own device, so the
    engine serves this index with no host-to-device index traffic. ``nt`` (default SYLPH_NT,
    else 4) > 1 makes the hash-tiled layout.

    ``dup`` switches to the duplication-skewed population (DupSpec): the
    grid carries G*KPG*(1-hf) short-run occurrences and the heavy CSR the
    remaining hf mass; dup.q is calibrated here when unset. With
    ``csr_host`` the heavy CSR is materialized, so the host paths
    (GRangeEngine.hists, heavy_expand) are exact (tests, small scales);
    without it the CSR stays virtual (heavy_ptr only, heavy_gids empty)
    and markers expand on the device (expand_markers_device)."""
    dev = resolve_device(device)
    if nt is None:
        nt = _default_nt()
    if dup is not None and nt <= 1:
        raise ValueError("duplication mode requires the tiled layout")
    M_total = G * KPG
    (M, n_chunks, B, CI, width, mean, spread), tg = _resolve(
        G, KPG, c, chunk_slots, target_mean, nt, dup)
    n_heavy = 0
    if dup is not None:
        n_cells = n_chunks * B * nt
        if dup.q is None:
            want_heavy = max(1.0, M_total * dup.hf / dup.lmean)
            dup.q = max(2, int(round(n_cells * dup.r / want_heavy)))
        n_heavy = -(-n_cells // dup.q) * dup.r
    ov = 0
    if nt > 1:
        _mt, _st, tile, ovpt, stride, _sw, cbase, cmod = tg
        CI = nt * tile + SYNTH_OV
        ov = SYNTH_OV
    chunk_keys, chunk_gid = [], []
    m = 0
    bases = np.zeros(n_chunks, np.uint32)
    edges = np.zeros((n_chunks, 2), np.uint64)
    for i in range(n_chunks):
        k, g = _chunk_device(i, B=B, CI=CI, width=width, G=G, mean=mean,
                             spread=spread, device=dev,
                             nt=nt, tg=tg, dup=dup, n_heavy=n_heavy)
        chunk_keys.append(k)
        chunk_gid.append(g)
        if dup is not None:
            # live non-marker grid slots (markers stand for CSR mass)
            cells = _counts_np_tiled_dup(i, B, nt, cbase, cmod, stride,
                                         dup.q, dup.r)
            gcell = np.arange(B * nt, dtype=np.int64) + np.int64(i) * B * nt
            m += int(cells[(gcell % dup.q) != 0].sum())
        elif nt > 1:
            m += int(_counts_np_tiled(i, B, nt, cbase, cmod, stride).sum())
        else:
            m += int(_counts_np(i, B, mean, spread).sum())
        lo_edge = np.uint64(i * B * width) << np.uint64(32)
        hi_edge = (np.uint64((i + 1) * B * width) << np.uint64(32)) \
            - np.uint64(1)
        bases[i] = np.uint32(i * B * width)
        edges[i] = (lo_edge, hi_edge)
    heavy_gids = np.empty(0, np.int32)
    heavy_ptr = np.zeros(1, np.int64)
    if dup is not None:
        if csr_host:
            heavy_gids, heavy_ptr = synth_heavy_csr_host(
                n_heavy, G, dup.lbase, dup.lmod)
        else:
            lens = heavy_lengths_np(n_heavy, dup.lbase, dup.lmod)
            heavy_ptr = np.zeros(n_heavy + 1, np.int64)
            np.cumsum(lens, out=heavy_ptr[1:])
        m += int(heavy_ptr[-1])
    return GRangeIndex(chunk_keys, chunk_gid, bases, edges, width, B, CI,
                       np.empty(0, np.uint64), np.empty(0, np.int32), m, G,
                       nt=nt if nt > 1 else 1, ov=ov,
                       heavy_gids=heavy_gids, heavy_ptr=heavy_ptr)


# ---- plants: index entries a read can carry ---------------------------------

def inv_mm_hash64(h: torch.Tensor) -> torch.Tensor:
    """Inverse of the bugged mm_hash64 on int64 bit patterns (the torch
    form of kmer/hashing.py::inv_mm_hash64_np): wrapping multiplies by the
    modular inverses, logical shift-xor back-substitution."""
    key = h * _as_i64(4611686016279904257)       # undo key += key << 31
    t = key ^ _lsr(key, 28)
    key = key ^ _lsr(t, 28)                       # undo key ^= key >> 28
    key = key * _as_i64(14933078535860113213)    # undo key *= 21
    t = key ^ _lsr(key, 14)
    t = key ^ _lsr(t, 14)
    t = key ^ _lsr(t, 14)
    key = key ^ _lsr(t, 14)                       # undo key ^= key >> 14
    key = key * _as_i64(15244667743933553977)    # undo key *= 265
    t = key ^ _lsr(key, 24)
    key = key ^ _lsr(t, 24)                       # undo key ^= key >> 24
    return (~key) * _as_i64(9223376434899189761)  # undo ~(key + key << 21)


def rc31(v: torch.Tensor) -> torch.Tensor:
    """Reverse complements of 31-mers packed 2-bit MSB-first in int64:
    complement the low 62 bits, reverse the 2-bit groups, shift down."""
    x = ~v & ((1 << 62) - 1)
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = (_lsr(x, sh) & m) | ((x & m) << sh)
    x = _lsr(x, 32) | (x << 32)
    return _lsr(x, 2)


def usable(h: torch.Tensor) -> torch.Tensor:
    """True where a hash inverts to a canonical 31-mer (v < 2^62 and
    v <= its reverse complement), which a read can then carry."""
    v = inv_mm_hash64(h)
    return (v >= 0) & (v < 1 << 62) & (v <= rc31(v))


def _slot_values(counter: torch.Tensor, chunk: int, *, B: int, CI: int,
                 width: int, G: int, nt: int, stride: int, subwidth: int,
                 dup: Optional[DupSpec]):
    """(key int64, gid int64) of slot counters: the torch form of the
    _slot_values_np* replays (flat, tiled, dup)."""
    if nt <= 1:
        v = _mix(counter, SALT_V)
        j = (counter // CI) % B
        hi = chunk * (B * width) + j * width + _lsr(v, 32) % width
        return _key(hi, v), _lo(_mix(counter, SALT_G)) % G
    gcell = counter // stride
    t = gcell % nt
    j = (gcell // nt) % B
    ch = gcell // (B * nt)
    span = torch.clamp(torch.clamp(width - t * subwidth, max=subwidth),
                       min=1)
    g = _lo(_mix(counter, SALT_G)) % G
    if dup is not None:
        s_loc = counter % stride
        heavy = gcell % dup.q == 0
        u = _lo(_mix(gcell, SALT_D)) % 1024
        cls = sum((u >= th).to(torch.int64) for th in DUP_T)
        dmask = torch.where(heavy, 0, (1 << cls) - 1)
        v = _mix(gcell * stride + (s_loc & ~dmask), SALT_V)
        g = torch.where(heavy, G + (gcell // dup.q) * dup.r + s_loc, g)
    else:
        v = _mix(counter, SALT_V)
    hi = ch * (B * width) + j * width + t * subwidth + _lsr(v, 32) % span
    return _key(hi, v), g


def synth_plants_host(G: int, KPG: int, c: int = 200, per_chunk: int = 4096,
                      gid_max: Optional[int] = None,
                      chunk_slots: int = 1 << 25,
                      target_mean: int = 1024,
                      nt: Optional[int] = None,
                      dup: Optional[DupSpec] = None,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """(kmer u64, gid int32) plantable index entries, regenerated from the
    counters on ``device`` (the index itself is never read).

    Strided-samples ``per_chunk`` live slots a chunk, keeps entries whose
    hash inverts to a canonical 31-mer, optionally only gid < gid_max (the
    "abundant taxa" pool). Dup mode (calibrated ``dup``): run values
    replace slot values, so plants of one run may repeat; heavy-marker
    entries carry gid = G + run and are left out of gid_max pools. Equal,
    bit for bit, to the JAX package's numpy function of the same name."""
    dev = resolve_device(device)
    if nt is None:
        nt = _default_nt()
    if dup is not None and not (nt > 1 and dup.q is not None):
        raise ValueError("dup mode needs the tiled layout and a calibrated q")
    (M, n_chunks, B, CI, width, mean, spread), tg = _resolve(
        G, KPG, c, chunk_slots, target_mean, nt, dup)
    stride = subw = 0
    if nt > 1:
        _mt, _st, _tile, _ovpt, stride, subw, cbase, cmod = tg
    ks, gs = [], []
    for i in range(n_chunks):
        if dup is not None:
            cnt = _counts_np_tiled_dup(i, B, nt, cbase, cmod, stride,
                                       dup.q, dup.r)
            n_units = B * nt
        elif nt > 1:
            cnt = _counts_np_tiled(i, B, nt, cbase, cmod, stride)
            n_units = B * nt
        else:
            cnt = _counts_np(i, B, mean, spread)
            n_units = B
        # subsample within cells (a slot stride): a strided subset of
        # cells would concentrate the pool in few cells and overflow the
        # join's per-cell sample capacity
        want = max(per_chunk, 1)
        # worst case ~7/8 rejected by invertibility + the gid_max filter
        over = 8 if gid_max is None else max(8, 8 * G // max(gid_max, 1))
        total_live = max(1, int(cnt.sum()))
        step = max(1, total_live // max(1, want * over))
        cj = torch.from_numpy(-(-cnt // step)).to(dev)   # slots a cell
        unit_stride = stride if nt > 1 else CI
        first = ((i * n_units + torch.arange(n_units, dtype=torch.int64,
                                             device=dev)) * unit_stride)
        total = int(cj.sum())
        starts = torch.cumsum(cj, 0) - cj
        r = (torch.arange(total, dtype=torch.int64, device=dev)
             - torch.repeat_interleave(starts, cj, output_size=total))
        counter = torch.repeat_interleave(first, cj, output_size=total) \
            + r * step
        del r, starts, first
        if dup is not None and gid_max is not None:
            # abundant pools hold real genomes only: drop marker cells
            counter = counter[(counter // unit_stride) % dup.q != 0]
        if gid_max is not None:
            # a cheap gid pass first: full-chunk scans hash only the
            # ~gid_max/G survivors further
            counter = counter[_lo(_mix(counter, SALT_G)) % G < gid_max]
        h, gid = _slot_values(counter, i, B=B, CI=CI, width=width, G=G,
                              nt=nt, stride=stride, subwidth=subw, dup=dup)
        del counter
        if gid_max is not None and bool((gid >= gid_max).any()):
            raise AssertionError("a plant of the gid_max pool has a gid "
                                 f">= {gid_max}")
        ok = usable(h)
        hk = h[ok]
        gk = gid[ok]
        if hk.numel() > per_chunk:
            hk = hk[::hk.numel() // per_chunk][:per_chunk]
            gk = gk[::gk.numel() // per_chunk][:per_chunk]
        ks.append(hk.cpu().numpy().view(np.uint64))
        gs.append(gk.to(torch.int32).cpu().numpy())
    return np.concatenate(ks), np.concatenate(gs)


# ---- heavy-run markers expanded on the device -------------------------------

def _marker_rows(hist: torch.Tensor, G: int, n_heavy: int) -> torch.Tensor:
    H = HIST_H
    return hist[G * H:G * H + n_heavy * H].reshape(n_heavy, H)


def _run_lengths(rr: torch.Tensor, lbase: int, lmod: int) -> torch.Tensor:
    return lbase + _lo(_mix(rr, SALT_L)) % lmod


def expand_markers_device(hist: torch.Tensor, *, G: int, n_heavy: int,
                          runs_cap: int, entries_cap: int, lbase: int,
                          lmod: int):
    """Expand heavy-run marker bins into real-genome counts on the device.

    ``hist`` is a [g_eff*HIST_H + 1] histogram from
    GRangeEngine.hist_device_stream over a dup-mode synthetic index; bins
    past G*H are marker rows, one a duplication run. A hit marker row is
    one-hot (a run's hash appears once in the folded sample), so for every
    hit run rr at multiplicity m, +1 goes to (gid, m) for each of its L_rr
    CSR genomes, the CSR regenerated from SALT_HG rather than read.

    Returns (expanded [G*H] in hist's dtype, ok 0-d bool): ok is True iff
    the compaction captured every marker hit (at most runs_cap rows and
    entries_cap CSR entries, every row one-hot with count 1); callers treat
    False like a failed conservation check (bigger caps). The first
    runs_cap hit rows and the first entries_cap entries are expanded, as
    the JAX package's nonzero(size=) and repeat(total_repeat_length=)
    truncate. Nothing here waits on the host."""
    H = HIST_H
    dev = hist.device
    mrows = _marker_rows(hist, G, n_heavy)
    rowsum = mrows.sum(dim=1)
    total_mass = rowsum.sum()
    hit = rowsum > 0
    # the first runs_cap hit rows, in order, n_heavy past the last hit
    pos = torch.cumsum(hit.to(torch.int64), 0) - 1
    slot = torch.where(hit & (pos < runs_cap), pos, runs_cap)
    idx = torch.full((runs_cap + 1,), n_heavy, dtype=torch.int64,
                     device=dev)
    idx.scatter_(0, slot, torch.arange(n_heavy, dtype=torch.int64,
                                       device=dev))
    idx = idx[:runs_cap]
    valid = idx < n_heavy
    idxc = torch.clamp(idx, max=max(n_heavy - 1, 0))
    rows = mrows[idxc]                               # [runs_cap, H]
    mult = torch.argmax(rows, dim=1)
    cnt = rows.max(dim=1).values
    captured = torch.where(valid, rows.sum(dim=1), 0).sum()
    onehot_ok = captured == torch.where(valid, cnt, 0).sum()
    ones_ok = torch.where(valid, cnt == 1, True).all()
    L = torch.where(valid, _run_lengths(idxc, lbase, lmod), 0)
    ends = torch.cumsum(L, 0)
    total_e = ends[-1] if runs_cap else torch.zeros((), dtype=torch.int64,
                                                    device=dev)
    # entry e belongs to the run whose [start, end) holds it
    e = torch.arange(entries_cap, dtype=torch.int64, device=dev)
    seg = torch.clamp(torch.searchsorted(ends, e, right=True),
                      max=max(runs_cap - 1, 0))
    i_loc = torch.clamp(e - (ends - L)[seg], min=0)
    gid = _lo(_mix((idxc[seg] << 32) | i_loc, SALT_HG)) % G
    code = torch.where(e < total_e, gid * H + mult[seg], G * H)
    delta = _bincount(code, G * H + 1)
    out = hist[:G * H] + delta[:G * H].to(hist.dtype)
    ok = ((captured == total_mass) & onehot_ok & ones_ok
          & (total_e <= entries_cap))
    return out, ok


def measure_marker_hits(hist: torch.Tensor, *, G: int, n_heavy: int,
                        lbase: int, lmod: int):
    """(hit marker rows, their CSR entries) as 0-d device tensors, for cap
    sizing from a warm-up histogram."""
    hit = _marker_rows(hist, G, n_heavy).sum(dim=1) > 0
    rr = torch.arange(n_heavy, dtype=torch.int64, device=hist.device)
    L = _run_lengths(rr, lbase, lmod)
    return hit.sum(), torch.where(hit, L, 0).sum()


def expand_markers_device_batched(hist_s: torch.Tensor, *, G: int,
                                  n_heavy: int, runs_cap: int,
                                  entries_cap: int, lbase: int, lmod: int):
    """[S, g_eff*H] rows -> ([S, G*H] expanded, ok 0-d bool): the cohort
    form of expand_markers_device (caps are per-sample maxima)."""
    outs = [expand_markers_device(row, G=G, n_heavy=n_heavy,
                                  runs_cap=runs_cap,
                                  entries_cap=entries_cap, lbase=lbase,
                                  lmod=lmod) for row in hist_s]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([k for _, k in outs]).all())
