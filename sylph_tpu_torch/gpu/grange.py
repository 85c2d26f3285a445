"""Global-range bucketed join: database-scale containment on one or several
GPUs, in one or several processes (counterpart of sylph_tpu/tpu/grange.py).

  build (host, once per database):
    all index k-mers are sorted by hash GLOBALLY (torch.sort on the engine's
    device), then cut into chunks of CHUNK consecutive slots. Within a
    chunk, hashes are uniform over the chunk's span, so width-bucketing
    gives Poisson-balanced buckets: a dense [B, CI] key grid (int64, pad -1)
    and a parallel [B, CI] genome-id grid. Over-occupied buckets spill to a
    host-side list; duplication runs longer than ``heavy_run`` become one
    marker slot plus a CSR of their genome ids.

  per sample (device):
    the sorted sample is sliced per chunk (searchsorted on the chunk hash
    edges: on the host for a host table, on the device for a streamed
    device-resident sample, which the device also sorts). For each chunk
    the B1 kernel fills the sample cell grid, the B2 kernel compares every
    index slot against its cell's sample lanes and emits column-compacted
    gid*64 + multiplicity codes (B4 when the column compaction would not
    shrink the block), and the B3 kernel
    repacks the sparse code stream. One histogram over all chunks' codes
    (a scatter-add of known size, no host sync) gives the per-genome
    coverage histograms [G, 64] that pass-1 statistics need. Conservation
    scalars (fill weight in == out, live codes before == after compaction)
    are checked per chunk; a failed chunk is recomputed by the lossless
    full-grid path (B1 + B5 + bincount).

  per batch of samples (device, hists_batched):
    S padded tables share one sweep: per chunk S fills, one batched compare
    (B2b, or B4b on dense batches) whose codes carry a sample tag s*G*64,
    one repack chain and, at the end, one histogram over S*G*64 bins. A
    batch that fails its conservation check is swept again per sample.

  several devices and processes (sylph_tpu/tpu/grange.py:1032-1095):
    chunk i lives on ``devices[i % n]`` (resident or streamed alike) and its
    kernels launch there, on the sample slice moved to that device; each
    device's conservation checks come back in one fetch and its good code
    streams go through one histogram, and the host sums the devices'
    histograms. With ``process_span=(i, n)`` the engine owns only the
    chunks j with j % n == i and ``hists`` returns this process's partial
    histogram (spill accounted by process 0 only); ``merge_process_hists``
    sums the partials over the process group. The streamed device view,
    the device mask and the batched sweeps are one-device paths, as in the
    JAX package: on several devices or under a span they are not taken.

  the stream sweep as one CUDA graph (hist_device_stream):
    on one CUDA device and process, with every chunk resident and no
    heavy runs, everything after the fold (device slices, the chunk loop,
    histogram and probe) is captured once per ``SweepShape`` (the
    integers baked into its launches, and the static input buffer's
    length) into one memory pool shared by the engine's graphs: the first
    sample of a shape runs eagerly and captures, each later one is copied
    into the static buffer and replayed, one launch on the host for some
    40 x 20 kernels. Elsewhere it runs eagerly, kernel by kernel.

The CUDA path is fixed (fill, fused compact codes, repack); the JAX
package's TPU switches are gone and their defaults are module constants.
"""

import logging
import os
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.distributed import allreduce_sum
from ..utils.timing import span, spanned, wait
from . import _cuda
from .bucket_fill import _n_windows, bucket_fill, repack1_flat
from .bucket_join import (_cell_ids, block_rows, cell_cs, join_codes,
                          join_codes_batched, join_codes_compact,
                          join_codes_compact_batched, join_counts,
                          sample_cs)
from .containment import _bincount
from .keys import HIST_H, KEY_PAD, SENT, from_pair_np, key_hi, u64_order

log = logging.getLogger("sylph")

_EMPTY_I32 = np.empty(0, np.int32)
_EMPTY_PTR = np.zeros(1, np.int64)

_HEAVY_RUN = 16               # duplication runs longer than this -> CSR
# code-compaction stop density of the repack chain (see _repack_chain)
_CODE_DENSITY = 0.5
# final-stream re-compaction floor: below this concatenated size the
# histogram is cheap enough that the extra chain + verify fetch lose
_RECOMPACT_MIN = 1 << 22
# spare bins a histogram's SENT lanes spread over (hist_from_codes)
SENT_BINS = 1024
# captured stream sweeps an engine keeps; a shape past them runs eagerly
# and is not captured (no eviction, so a stream of many shapes costs
# what an eager sweep costs, never a capture a sample). Streams of fresh
# benchmark samples make 1-3 shapes a traffic; the plan's quantisation
# gives about 14 an octave of sample size
_GRAPHS_MAX = 32


def resolve_device(device) -> torch.device:
    """torch.device for an engine; asking for CUDA without a GPU raises
    (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA GPU is available; ask for "
            "the CPU explicitly (device='cpu', --device cpu)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate arange(s, s + l) for each (start, len) pair — the
    vectorized CSR-segment gather used by heavy-run handling."""
    lens = np.asarray(lens, np.int64)
    tot = int(lens.sum())
    if tot == 0:
        return np.empty(0, np.int64)
    nz = lens > 0
    sv = np.asarray(starts, np.int64)[nz]
    lv = lens[nz]
    firsts = np.cumsum(lv) - lv          # offsets of each segment in out
    step = np.ones(tot, np.int64)
    step[0] = sv[0]
    if sv.size > 1:
        step[firsts[1:]] = sv[1:] - (sv[:-1] + lv[:-1] - 1)
    return np.cumsum(step)


class GRangeIndex(NamedTuple):
    """Chunked layout; device residency is managed by the engine.

    ``nt`` > 1 selects the hash-tiled bucket layout: each bucket's CI
    columns split into nt TILEs of (CI - ov)/nt slots holding the bucket's
    t-th hash sub-range ([t*subwidth, (t+1)*subwidth) within the bucket,
    subwidth = ceil(width/nt)), plus a shared ``ov``-column overflow region.
    Heavy duplication runs keep ONE representative slot with marker gid
    ``n_genomes + r``; the run's real genome ids live in the
    ``heavy_gids``/``heavy_ptr`` CSR."""
    chunk_keys: List[torch.Tensor]   # per chunk [B, CI] int64 (pad -1)
    chunk_gid: List[torch.Tensor]    # per chunk [B, CI] int32 (pad g_eff)
    bases: np.ndarray             # [n_chunks] uint32 hash_hi bucket origin
    edges_u64: np.ndarray         # [n_chunks, 2] first/last u64 hash in chunk
    width: int                    # uniform bucket width (hash_hi units)
    B: int                        # buckets per chunk
    CI: int                       # uniform index bucket capacity
    spill_kmers: np.ndarray       # [S] uint64 over-capacity slots
    spill_gids: np.ndarray        # [S] int32
    m: int                        # live index k-mers (incl. spill + heavy)
    n_genomes: int
    nt: int = 1                   # hash sub-range tiles per bucket
    ov: int = 0                   # shared overflow columns per bucket
    heavy_gids: np.ndarray = _EMPTY_I32   # CSR values: run genome ids
    heavy_ptr: np.ndarray = _EMPTY_PTR    # [n_heavy + 1] CSR offsets

    @property
    def tile(self) -> int:
        return (self.CI - self.ov) // max(self.nt, 1)

    @property
    def subwidth(self) -> int:
        return -(-self.width // max(self.nt, 1))

    @property
    def n_heavy(self) -> int:
        return int(self.heavy_ptr.size) - 1

    @property
    def g_eff(self) -> int:
        """Code-space genome count: real genomes + heavy-run markers."""
        return self.n_genomes + self.n_heavy


def index_from_numpy(fields: dict) -> GRangeIndex:
    """The port's index from a JAX-package GRangeIndex given as plain
    numpy fields (``jax_index._asdict()``): the (hi, lo) uint32 [B, CI]
    grids become one int64 key grid per chunk, (SENT, SENT) -> -1."""
    keys = [torch.from_numpy(np.ascontiguousarray(from_pair_np(h, lo)))
            for h, lo in zip(fields["chunk_hi"], fields["chunk_lo"])]
    gids = [torch.from_numpy(np.ascontiguousarray(g, np.int32))
            for g in fields["chunk_gid"]]
    return GRangeIndex(
        keys, gids, np.asarray(fields["bases"], np.uint32),
        np.asarray(fields["edges_u64"], np.uint64), int(fields["width"]),
        int(fields["B"]), int(fields["CI"]),
        np.asarray(fields["spill_kmers"], np.uint64),
        np.asarray(fields["spill_gids"], np.int32), int(fields["m"]),
        int(fields["n_genomes"]), nt=int(fields["nt"]), ov=int(fields["ov"]),
        heavy_gids=np.asarray(fields["heavy_gids"], np.int32),
        heavy_ptr=np.asarray(fields["heavy_ptr"], np.int64))


def _sort_kv(kmers_u64: np.ndarray, gids: np.ndarray, device):
    """Stable sort of (kmer, gid) by kmer in uint64 order on ``device``
    -> host (uint64 keys, int32 gids). The int64 patterns sort on
    ``u64_order`` (at c = 1 a hash can be 2^63 or more, negative as an
    int64), flipped in place and back, as the JAX package sorts its uint64
    keys (sylph_tpu/tpu/grange.py:196-204)."""
    dev = torch.device(device)
    k = torch.from_numpy(np.ascontiguousarray(kmers_u64, np.uint64)
                         .view(np.int64)).to(dev, copy=True)
    g = torch.from_numpy(np.ascontiguousarray(gids, np.int32)).to(dev)
    sk, order = torch.sort(u64_order(k, inplace=True), stable=True)
    del k
    sg = g[order]
    del g, order
    su = u64_order(sk, inplace=True).cpu().numpy().view(np.uint64)
    sg = sg.cpu().numpy()
    del sk
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return su, sg


def build_grange_index(kmers_u64: np.ndarray, gids: np.ndarray,
                       n_genomes: int, chunk_slots: int = 1 << 25,
                       target_mean: Optional[int] = None,
                       ci_cap: Optional[int] = None,
                       nt: Optional[int] = None,
                       ov: int = 128,
                       heavy_run: Optional[int] = None,
                       device="cuda") -> GRangeIndex:
    """Sort the flat (kmer, gid) index by hash (on ``device``) and lay it
    out in range chunks. ``ci_cap`` bounds the flat bucket capacity
    (defaults to a generous Poisson tail); deeper buckets spill.
    ``nt`` > 1 selects the hash-tiled
    layout; None takes SYLPH_NT where it is set to a number, else picks
    nt=4 iff the fullest chunk's real per-bucket mean is >= 896, else the
    flat layout. Duplication runs longer than ``heavy_run`` (default
    SYLPH_HEAVY_RUN, else 16; 0 disables) go to the heavy CSR. Same
    layout, field by field, as sylph_tpu's build_grange_index."""
    m_total = m = int(kmers_u64.size)
    if target_mean is None:
        target_mean = 1024
    if nt is None:
        env_nt = os.environ.get("SYLPH_NT", "auto")
        if env_nt != "auto":
            nt = int(env_nt)
    su, sg = _sort_kv(kmers_u64, gids, resolve_device(device))

    heavy_gids, heavy_ptr = _EMPTY_I32, _EMPTY_PTR
    if heavy_run is None:
        heavy_run = int(os.environ.get("SYLPH_HEAVY_RUN", str(_HEAVY_RUN)))
    if heavy_run > 0 and m > 1:
        first = np.empty(m, bool)
        first[0] = True
        np.not_equal(su[1:], su[:-1], out=first[1:])
        rstarts = np.flatnonzero(first)
        rlens = np.diff(np.append(rstarts, m))
        hsel = rlens > heavy_run
        nh = int(np.count_nonzero(hsel))
        # code space is int32 downstream: (g_eff)*HIST_H must stay below
        # 2^31, so keep only the longest runs if a pathological index
        # would overflow it
        nh_cap = max(0, (1 << 27) // HIST_H * 16 - n_genomes - 2)
        if nh > nh_cap:
            keep_runs = np.argpartition(rlens[hsel], nh - nh_cap
                                        )[nh - nh_cap:]
            sel_idx = np.flatnonzero(hsel)
            hsel = np.zeros_like(hsel)
            hsel[sel_idx[keep_runs]] = True
            nh = nh_cap
        if nh:
            hstarts = rstarts[hsel].astype(np.int64)
            hlens = rlens[hsel].astype(np.int64)
            hidx = _ranges(hstarts, hlens)
            heavy_gids = np.ascontiguousarray(sg[hidx], np.int32)
            heavy_ptr = np.zeros(nh + 1, np.int64)
            np.cumsum(hlens, out=heavy_ptr[1:])
            keep = np.ones(m, bool)
            keep[hidx] = False
            keep[hstarts] = True
            sg[hstarts] = n_genomes + np.arange(nh, dtype=np.int32)
            su = su[keep]
            sg = sg[keep]
            m = int(su.size)
        del first, rstarts, rlens, hsel
    g_eff = n_genomes + (int(heavy_ptr.size) - 1)

    n_chunks = max(1, -(-m // chunk_slots))
    B = 1 << max(0, int(np.ceil(np.log2(max(1, chunk_slots // target_mean)))))
    mean = chunk_slots / B
    if nt is None:
        nt = 4 if min(m, chunk_slots) / B >= 896 else 1

    starts = [ci * chunk_slots for ci in range(n_chunks)]
    ends = [min(s + chunk_slots, m) for s in starts]
    spans = [int((su[e - 1] >> np.uint64(32)) - (su[s] >> np.uint64(32)))
             for s, e in zip(starts, ends)]
    width = max(1, max(spans) // B + 1)

    if ci_cap is None:
        z = np.sqrt(2.0 * np.log(max(2.0, float(B * n_chunks)))) + 2.0
        ci_cap = int(mean + z * np.sqrt(mean) + 8)
        ci_cap = -(-ci_cap // 128) * 128

    if nt > 1:
        tile = max(128, 128 * int(round(mean / nt / 128 + 0.25)))
        ov = max(128, -(-ov // 128) * 128)
        subwidth = -(-width // nt)
    chunk_keys, chunk_gid = [], []
    bases = np.zeros(n_chunks, np.uint32)
    edges = np.zeros((n_chunks, 2), np.uint64)
    spill_k, spill_g = [], []
    ci_used = 8
    per_chunk = []                # nt == 1: (b, col, keys, gid)
    for ci_i, (s, e) in enumerate(zip(starts, ends)):
        cu = su[s:e]
        cg = sg[s:e]
        base = np.uint32(cu[0] >> np.uint64(32))
        bases[ci_i] = base
        edges[ci_i] = (cu[0], cu[-1])
        hi32 = (cu >> np.uint64(32)).astype(np.uint32)
        b = ((hi32.astype(np.int64) - int(base)) // width)
        del hi32
        ck = cu.view(np.int64)
        if nt > 1:
            within = (cu >> np.uint64(32)).astype(np.int64) - int(base) \
                - b * width
            sub = np.minimum(within // subwidth, nt - 1)
            cell = b * nt + sub
            cc = np.bincount(cell, minlength=B * nt)
            rank_c = np.arange(cu.size, dtype=np.int64) - np.concatenate(
                [[0], np.cumsum(cc)])[cell]
            in_tile = rank_c < tile
            ovf = ~in_tile
            bo = b[ovf]
            cb = np.bincount(bo, minlength=B)
            rank_o = np.arange(bo.size, dtype=np.int64) - np.concatenate(
                [[0], np.cumsum(cb)])[bo]
            col = np.where(in_tile, sub * tile + rank_c, 0)
            col[ovf] = nt * tile + rank_o
            over = np.zeros(cu.size, bool)
            over[ovf] = rank_o >= ov
            del within, sub, cell, rank_c, in_tile, ovf, bo, rank_o
        else:
            counts = np.bincount(b, minlength=B)
            col = np.arange(cu.size, dtype=np.int64) - np.concatenate(
                [[0], np.cumsum(counts)])[b]
            over = col >= ci_cap
        if over.any():
            spill_k.append(cu[over])
            spill_g.append(cg[over])
            keep = ~over
            b, col, ck, cg = b[keep], col[keep], ck[keep], cg[keep]
        if nt > 1:
            ok = np.full((B, nt * tile + ov), KEY_PAD, np.int64)
            og = np.full((B, nt * tile + ov), g_eff, np.int32)
            ok[b, col] = ck
            og[b, col] = cg
            chunk_keys.append(torch.from_numpy(ok))
            chunk_gid.append(torch.from_numpy(og))
            del b, col, ck, cg
        else:
            ci_used = max(ci_used,
                          int(col.max()) + 1 if col.size else 0)
            per_chunk.append((b, col, ck, cg))

    CI = (nt * tile + ov) if nt > 1 else max(8, -(-ci_used // 8) * 8)
    for b, col, ck, cg in per_chunk:
        ok = np.full((B, CI), KEY_PAD, np.int64)
        og = np.full((B, CI), g_eff, np.int32)
        ok[b, col] = ck
        og[b, col] = cg
        chunk_keys.append(torch.from_numpy(ok))
        chunk_gid.append(torch.from_numpy(og))

    spill_k = (np.concatenate(spill_k) if spill_k
               else np.empty(0, np.uint64))
    spill_g = (np.concatenate(spill_g) if spill_g
               else np.empty(0, np.int32))
    if spill_g.size and heavy_gids.size:
        # a spilled MARKER slot leaves the grid entirely; expand it to its
        # run's real (kmer, gid) pairs so the host spill probe stays exact
        mk = spill_g >= n_genomes
        if mk.any():
            r = spill_g[mk].astype(np.int64) - n_genomes
            lens_r = heavy_ptr[r + 1] - heavy_ptr[r]
            hidx = _ranges(heavy_ptr[r], lens_r)
            spill_k = np.concatenate([spill_k[~mk],
                                      np.repeat(spill_k[mk], lens_r)])
            spill_g = np.concatenate([spill_g[~mk], heavy_gids[hidx]])

    return GRangeIndex(
        chunk_keys, chunk_gid, bases, edges, width, B, CI,
        spill_k, spill_g, m_total, n_genomes,
        nt=nt if nt > 1 else 1, ov=ov if nt > 1 else 0,
        heavy_gids=heavy_gids, heavy_ptr=heavy_ptr)


def slice_sample(gidx: GRangeIndex, skmers_u64: np.ndarray
                 ) -> List[Tuple[int, int]]:
    """[start, end) into the sorted sample for each chunk; slices overlap
    where a duplicated hash value straddles a chunk boundary."""
    out = []
    for ci in range(len(gidx.chunk_keys)):
        lo_u, hi_u = gidx.edges_u64[ci]
        s = int(np.searchsorted(skmers_u64, lo_u, side="left"))
        e = int(np.searchsorted(skmers_u64, hi_u, side="right"))
        out.append((s, e))
    return out


def _pad_slice(skey: torch.Tensor, sw: torch.Tensor, s: int, e: int,
               P: int):
    """Length-P window [s, e) of the sorted sample, KEY_PAD / 0 tail."""
    out_k = torch.full((P,), KEY_PAD, dtype=torch.int64, device=skey.device)
    out_w = torch.zeros((P,), dtype=sw.dtype, device=sw.device)
    n = e - s
    out_k[:n] = skey[s:e]
    out_w[:n] = sw[s:e]
    return out_k, out_w


def _gather_slices(keys: torch.Tensor, sw: torch.Tensor,
                   starts: torch.Tensor, ends: torch.Tensor, P: int):
    """[S, P] windows [starts[s], ends[s]) of the rows of an [S, T] table,
    KEY_PAD / 0 past each window's end, gathered on the table's device."""
    lane = torch.arange(P, device=keys.device)
    idx = starts[:, None] + lane[None, :]
    m = idx < ends[:, None]
    idx = idx.clamp(max=keys.shape[1] - 1)
    return (torch.where(m, keys.gather(1, idx), KEY_PAD),
            torch.where(m, sw.gather(1, idx), 0))


def _repack_codes(v: torch.Tensor, steps) -> torch.Tensor:
    """Repack (B3) a sparse SENT-coded int32 stream by the (row, cap)
    passes ``steps`` (``_repack_chain``'s). Capacities are
    conservation-checked by the caller (n_live == n_comp), so overflow is
    detected, never silent."""
    for row, cap in steps:
        v = repack1_flat(v, row=row, cap=cap)
    return v


def _repack_chain(n: int, density: float) -> tuple:
    """((row, cap), ...) of the repack passes over an n-slot code stream at
    density ``density``: windows widen as the stream gets sparser (up to
    32k slots); the first pass keeps a 4x-expectation capacity, later
    passes 1.5x + 8 sigma."""
    steps, d, mult = [], max(density, 1e-6), 4.0
    while (step := _repack_step(n, d, mult)) is not None:
        row, cap = step
        steps.append(step)
        n = _n_windows(n, row) * cap
        d = d * row / cap
        mult = 1.5
    return tuple(steps)


def _repack_step(n: int, d: float, mult: float):
    """(row, cap) of the next repack pass over an n-slot stream at density
    ``d`` with capacity multiplier ``mult``, or None where the chain stops:
    the widest window (1024..32768 slots) whose expected occupancy keeps
    cap well below row."""
    if d >= _CODE_DENSITY or n <= 4 * 1024:
        return None
    row = 1024
    while row < 32768 and row * 2 * d < 768 and n > 4 * row * 2:
        row *= 2
    exp = row * d
    cap = 256 * int(np.ceil((mult * exp + 8.0 * np.sqrt(exp) + 32) / 256))
    return None if cap >= row else (row, cap)


def _capr(density: float, TB: int) -> int:
    """Per-column capacity of the compare kernel's code compaction."""
    exp = density * TB
    cap = int(np.ceil(4.0 * exp + 8.0 * np.sqrt(exp) + 4.0))
    return min(TB, max(8, -(-cap // 8) * 8))


def _code_plan(density: float, B: int, CI: int, S: int = 1):
    """(capr, repack steps) that a chunk's compare and repack chain bake
    into their launches for S samples at code density ``density``: the
    compare's per-column capacity (TB where the column compaction would
    not shrink the block, and B4 runs instead of B2) and the passes of
    ``_repack_chain`` over the compare's output."""
    TB = block_rows(B)
    capr = _capr(density, TB) if B % TB == 0 else TB
    if capr < TB:
        return capr, _repack_chain(S * B // TB * capr * CI,
                                   density * TB / capr)
    return capr, _repack_chain(S * B * CI, density)


def _chunk_codes(ikey, gid_grid, skey, sw, base: int, **kw):
    """One chunk, one sample: _chunk_codes_batched at S = 1 (kernels B1, B2
    or B4, B3)."""
    return _chunk_codes_batched(ikey, gid_grid, skey[None], sw[None], base,
                                **kw)


def _chunk_codes_batched(ikey, gid_grid, skey_s, sw_s, base: int, *,
                         width: int, B: int, CS: int, n_genomes: int,
                         density: Optional[float] = None, plan=None,
                         nt: int = 1, subwidth: int = 0, ov: int = 0):
    """S sample slices ([S, P] sorted keys and weights) x one chunk: per
    sample the fill (B1), then one compare/code emission over the batch
    (B2b, or B4b when the column compaction would not shrink the block; B2
    and B4 at S = 1) and one repack chain (B3) over the sample-tagged
    stream. Codes are s*(G*H) + gid*H + mult, flattened sample-major and
    column-major within a sample, as the JAX package flattens them.

    Returns (codes, n_live, n_compacted, w_lost), each summed over the
    batch — callers verify n_live == n_compacted (compaction capacities)
    and w_lost == 0 (sample cell capacity CS honored). ``nt`` > 1:
    hash-tiled index layout — CS is the per-CELL lane capacity and the cell
    grids are viewed as [B, nt*CS] so each index tile only scans its own
    lane group. ``plan``: (capr, repack steps) as ``_code_plan`` gives
    them for the code density ``density``, computed here where not
    given."""
    S = skey_s.shape[0]
    with span("sweep.fill"):
        sw_s = sw_s.to(torch.int32)
        fills = [bucket_fill(skey_s[s], sw_s[s], base, width=width, B=B,
                             CS=CS, nt=nt, subwidth=subwidth)
                 for s in range(S)]
        dk = torch.stack([k.view(B, nt * CS) for k, _ in fills])
        dw = torch.stack([w.view(B, nt * CS) for _, w in fills])
        _raw, _nb, in_range = _cell_ids(key_hi(skey_s), width=width, B=B,
                                        base=base)
        w_in = torch.where(in_range, sw_s, 0).sum(dtype=torch.int64)
    G = n_genomes
    CI = ikey.shape[1]
    kw = dict(G=G, nt=nt, tile=(CI - ov) // nt if nt > 1 else 0)
    TB = block_rows(B)
    capr, steps = plan if plan is not None else _code_plan(density, B, CI,
                                                           S)
    with span("sweep.join"):
        if capr < TB:
            if S == 1:
                codes, n_live = join_codes_compact(ikey, gid_grid, dk[0],
                                                   dw[0], CAPR=capr, **kw)
                codes = codes[None]
            else:
                codes, n_live = join_codes_compact_batched(
                    ikey, gid_grid, dk, dw, CAPR=capr, **kw)
            # each column's codes are top-packed into its first rows, so a
            # row-major flattening would crowd the live codes into the
            # leading repack windows; flatten column-major (as the JAX
            # package does)
            codes = codes.transpose(1, 2).contiguous()
        else:
            codes = (join_codes(ikey, gid_grid, dk[0], dw[0], **kw)[None]
                     if S == 1 else
                     join_codes_batched(ikey, gid_grid, dk, dw, **kw))
            n_live = (codes != SENT).sum(dtype=torch.int64)
    with span("sweep.repack"):
        codes = _repack_codes(codes.reshape(-1), steps)
        n_comp = (codes != SENT).sum(dtype=torch.int64)
    return (codes, n_live, n_comp,
            (w_in - dw.sum(dtype=torch.int64)).abs())


def hist_from_codes(codes: torch.Tensor, *, n_genomes: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[G*H+1] int64 histogram of a concatenated gid*H+mult code stream;
    SENT (-1) lands in the last bin, G*H.

    No host sync (``torch.bincount`` reads the codes' min and max on the
    host): a scatter-add into a buffer of known size, ``out`` ([G*H +
    SENT_BINS] int64, overwritten; the result is a view of it) or a new
    one. About half a repacked stream is SENT, and atomic adds into one
    bin queue, so the SENT lanes spread over SENT_BINS spare bins whose
    sum then lands in bin G*H."""
    nb = n_genomes * HIST_H
    v = codes.reshape(-1)
    if out is None:
        out = torch.empty(nb + SENT_BINS, dtype=torch.int64, device=v.device)
    out.zero_()
    spare = torch.arange(v.numel(), device=v.device)
    spare.bitwise_and_(SENT_BINS - 1).add_(nb)
    seg = torch.where(v != SENT, v, spare)
    one = torch.ones((), dtype=torch.int64, device=v.device)
    out.index_add_(0, seg, one.expand(v.numel()))
    out[nb] = out[nb:].sum()
    return out[:nb + 1]


def _chunk_hist_lossless(ikey, gid_grid, skey, sw, base: int, *,
                         width: int, B: int, CS: int,
                         n_genomes: int) -> torch.Tensor:
    """Compaction-free redo of one chunk: flat fill (B1), the full count
    grid (B5) and a bincount over it."""
    sw = sw.to(torch.int32)
    dk, dw = bucket_fill(skey, sw, base, width=width, B=B, CS=CS)
    grid = join_counts(ikey, dk, dw)
    G, H = n_genomes, HIST_H
    live = (grid > 0) & (gid_grid < G)
    seg = torch.where(live, gid_grid.to(torch.int64) * H
                      + torch.clamp(grid, max=H - 1), G * H)
    with wait("sweep.bincount"):
        return _bincount(seg, G * H + 1)


@spanned("fold")
def fold_stream(keys: torch.Tensor, clamp: int = HIST_H - 1):
    """(distinct keys int64 in uint64 order, uint8 weights) of an
    occurrence stream of int64 keys (any shape and order, -1 pads
    anywhere) on its device: the reference's kmer_counts multiplicity map
    (sylph src/sketch.rs:930-939). The pads are dropped before the sort,
    which runs on ``u64_order`` as the JAX package sorts its uint64 keys;
    weights clamp at ``clamp`` (H-1 of the caller's histogram, at most
    255) losslessly, as in ``upload_sample``."""
    if not 1 <= clamp <= 255:
        raise ValueError(f"uint8 weights hold a clamp of 1 to 255, not "
                         f"{clamp}")
    flat = keys.reshape(-1)
    with wait("fold.mask"):
        live = flat[flat != KEY_PAD]
    live = torch.sort(u64_order(live)).values
    with wait("fold.unique"):
        skey, cnt = torch.unique_consecutive(live, return_counts=True)
    return u64_order(skey), cnt.clamp(max=clamp).to(torch.uint8)


def _quantize_p(want: float, t=None) -> int:
    """Per-chunk slice length: ``want`` rounded up to a quarter-octave step
    (multiple of 2048), capped by ``t`` when given."""
    want = max(1024.0, want)
    q = np.ceil(np.log2(want) * 4.0) / 4.0
    p = int(-(-(2.0 ** q) // 2048) * 2048)
    return p if t is None else min(p, t)


class SweepShape(NamedTuple):
    """What hist_device_stream bakes into its launches for a sample, and
    the key of its captured graph: the slice length, the cell capacity,
    the compare's per-column capacity, the repack chain's (row, cap)
    passes, and the length of the static input buffer a replay copies the
    sample into (the next power of two of the sample, at least 1024, as
    ``upload_tables`` pads)."""
    P: int
    CS: int
    capr: int
    steps: tuple
    Tcap: int


def _tcap(t: int) -> int:
    return max(1024, 1 << int(np.ceil(np.log2(max(t, 1)))))


def stage_sample(keys: torch.Tensor, w: torch.Tensor, skey: torch.Tensor,
                 w_dev: torch.Tensor) -> None:
    """Copy a sorted sample (``skey``, ``w_dev``) into the static buffers
    ``keys`` (int64) and ``w`` (int32) of a longer length, with a KEY_PAD
    and 0 tail. The tail never enters a slice: KEY_PAD is u64::MAX, which
    no kept hash is, so no chunk edge is either, and the tail sorts after
    every chunk's last hash in uint64 order (as in ``batched_slices``);
    ``chunk_slice``'s mask cuts each slice at its end, so clamping at the
    buffer's end gives the slices that clamping at the sample's gives."""
    t = int(skey.shape[0])
    keys[:t].copy_(skey)
    keys[t:].fill_(KEY_PAD)
    w[:t].copy_(w_dev)
    w[t:].zero_()


def chunk_slice(skey: torch.Tensor, sw: torch.Tensor, start, end,
                lane: torch.Tensor):
    """One chunk's [P] slice (keys, weights) of a sorted sample, gathered
    on the device from its [start, end) and padded with KEY_PAD and 0."""
    t = int(skey.shape[0])
    idx = start + lane
    m = idx < end
    idx = idx.clamp(max=max(t - 1, 0))
    return torch.where(m, skey[idx], KEY_PAD), torch.where(m, sw[idx], 0)


class GRangeEngine:
    """Device-resident grange index serving per-sample [G, H] histograms.

    ``devices`` (default: the one ``device``) holds the chunks round-robin,
    chunk i on ``devices[i % len(devices)]``; a list may name one device
    more than once (logical devices sharing a card). ``max_resident_chunks``
    bounds device residency for databases larger than device memory: of
    chunks 0..N-1, those this engine owns stay resident, and every other
    owned chunk uploads per sample (the next chunk's upload is issued before the current
    chunk's kernels). None = everything resident. ``process_span=(i, n)``
    makes this engine own only the chunks j with j % n == i (one process
    of n); ``hists`` then returns this process's partial histogram."""

    def __init__(self, gidx: GRangeIndex, device="cuda",
                 max_resident_chunks: Optional[int] = None, devices=None,
                 process_span: Optional[Tuple[int, int]] = None):
        self.gidx = gidx
        self._GE = gidx.g_eff       # code-space genomes (real + markers)
        self.devices = [resolve_device(d) for d in (
            devices if devices is not None else [device])]
        if not self.devices:
            raise ValueError("a grange engine needs at least one device")
        self.device = self.devices[0]
        if process_span is not None:
            pid, npr = process_span
            if not 0 <= pid < npr:
                raise ValueError(f"bad process span {process_span}")
        self._span = process_span
        n_chunks = len(gidx.chunk_keys)
        n_res = (n_chunks if max_resident_chunks is None
                 else max(0, min(max_resident_chunks, n_chunks)))
        self._dev_chunks = {i: self._upload(i) for i in range(n_res)
                            if self._owns(i)}
        # (first, last) hash of every chunk as u64_order keys, on the first
        # device: searchsorted of a device-sorted sample (a one-device
        # path) compares in that order
        e = np.ascontiguousarray(gidx.edges_u64, np.uint64).view(np.int64)
        self._edges = u64_order(torch.from_numpy(e)).to(self.device)
        # sweeps of the index: per-sample (hists), batched (hists_batched)
        # and batched ones whose probe sent them back to per-sample sweeps;
        # for streamed samples, device sorts, masks from the one-fetch
        # stream sweep, and stream sweeps whose probe sent them back
        # and stream sweeps replayed from a captured graph, those that ran
        # eagerly and captured their shape's graph, and those that ran
        # eagerly where no graph is used
        self.counters = {"hists_sweeps": 0, "batched_sweeps": 0,
                         "batched_rejected": 0, "device_view_sorts": 0,
                         "mask_stream_masks": 0, "mask_stream_rejected": 0,
                         "stream_graph_replays": 0,
                         "stream_graph_captures": 0,
                         "stream_eager_sweeps": 0}
        self._graphs = {}       # SweepShape -> (CUDAGraph, launches held)
        self._graph_in = {}     # Tcap -> static (keys, weights) buffers
        self._graph_out = None  # static (histogram, probe) buffers
        self._graph_pool = None
        self._graph_side = None  # the stream captures run on

    def _owns(self, i: int) -> bool:
        """Chunk ownership: every chunk, or under a process span the
        round-robin subset j % n == i."""
        return self._span is None or i % self._span[1] == self._span[0]

    def _owns_sides(self) -> bool:
        """The spill side channel: exactly one process accounts it."""
        return self._span is None or self._span[0] == 0

    def _one_device(self) -> bool:
        """The one-device, one-process engine: the only one that takes the
        streamed device view, the device mask and the batched sweeps (JAX's
        gates, sylph_tpu/engine/device_exec.py:321-323, 438-439, 456-457;
        DeviceContainment asks its engine)."""
        return len(self.devices) == 1 and self._span is None

    def _chunk_device(self, i: int) -> torch.device:
        return self.devices[i % len(self.devices)]

    def _upload(self, i: int):
        g = self.gidx
        dev = self._chunk_device(i)
        return (g.chunk_keys[i].to(dev, non_blocking=True),
                g.chunk_gid[i].to(dev, non_blocking=True))

    def _chunk_dev(self, i: int):
        """Device tensors for chunk i on its device: resident, or a
        per-use upload."""
        hit = self._dev_chunks.get(i)
        return hit if hit is not None else self._upload(i)

    def _require_one_device(self, what: str) -> None:
        if not self._one_device():
            raise RuntimeError(
                f"{what} sweeps every chunk on one device; an engine on "
                f"{len(self.devices)} device(s) with process span "
                f"{self._span} serves hists() (and merge_process_hists)")

    def heavy_expand(self, hh: np.ndarray) -> np.ndarray:
        """[n_heavy, H] marker-row counts -> [G, H] real-genome counts.
        Raises on an index whose CSR is virtual (heavy_ptr without its
        heavy_gids, as the synthetic index leaves it by default)."""
        g = self.gidx
        G, H = g.n_genomes, HIST_H
        out = np.zeros((G, H), np.int64)
        ptr, hg = g.heavy_ptr, g.heavy_gids
        if hg.size != int(ptr[-1]):
            raise ValueError(
                f"the heavy CSR holds {hg.size} genome ids for "
                f"{int(ptr[-1])} entries (a virtual CSR): expand its "
                "markers on the device (gpu/synth_index.py::"
                "expand_markers_device)")
        for mlt in range(H):
            rows = np.flatnonzero(hh[:, mlt])
            if not rows.size:
                continue
            lens = ptr[rows + 1] - ptr[rows]
            hidx = _ranges(ptr[rows], lens)
            cnt = np.repeat(hh[rows, mlt].astype(np.int64), lens)
            seg = hg[hidx].astype(np.int64) * H + mlt
            out += np.bincount(seg, weights=cnt,
                               minlength=G * H).astype(np.int64
                                                       ).reshape(G, H)
        return out

    def _fold_heavy(self, hist_eff: np.ndarray) -> np.ndarray:
        """[g_eff*H...] flat histogram -> [G, H] with markers expanded."""
        G, H = self.gidx.n_genomes, HIST_H
        out = hist_eff[:G * H].astype(np.int64).reshape(G, H)
        nh = self.gidx.n_heavy
        if nh:
            hh = hist_eff[G * H:self._GE * H].reshape(nh, H)
            if hh.any():
                out = out + self.heavy_expand(hh)
        return out

    def _spill_hist(self, skmers_u64: np.ndarray,
                    scounts: np.ndarray) -> np.ndarray:
        """[G, H] contribution of the (tiny) host-side spill list. An empty
        sample adds nothing (the JAX package's copy indexes the empty
        table and raises, sylph_tpu/tpu/grange.py:1489)."""
        gidx = self.gidx
        G, H = gidx.n_genomes, HIST_H
        out = np.zeros((G, H), np.int64)
        if skmers_u64.size == 0:
            return out
        idx = np.searchsorted(skmers_u64, gidx.spill_kmers)
        idxc = np.minimum(idx, max(skmers_u64.size - 1, 0))
        found = (skmers_u64.size > 0) & (idx < skmers_u64.size)
        found = found & (skmers_u64[idxc] == gidx.spill_kmers)
        cts = np.where(found, scounts[idxc], 0).astype(np.int64)
        live = cts > 0
        if live.any():
            seg = (gidx.spill_gids[live].astype(np.int64) * H
                   + np.minimum(cts[live], H - 1))
            out += np.bincount(seg, minlength=G * H).reshape(G, H)
        return out

    def plan(self, skmers_u64: np.ndarray):
        """Per-sample sizing of the chunk sweep: (slices, P, CS, density)
        — each chunk's [start, end) in the sorted sample, the padded slice
        length, the per-cell sample capacity and the code-density
        estimate that sizes the compaction capacities."""
        return self._plan_slices(slice_sample(self.gidx, skmers_u64))

    def _plan_slices(self, slices):
        gidx = self.gidx
        max_n = max((e - s for s, e in slices), default=0)
        P = _quantize_p(float(max(max_n, 1)))
        if gidx.nt > 1:
            CS = cell_cs(P, gidx.B * gidx.nt)
        else:
            CS = sample_cs(P, gidx.B, granularity=8)
        density = min(1.0, 4.0 * P / max(1, gidx.B * gidx.CI))
        return slices, P, CS, density

    def upload_sample(self, skmers_u64: np.ndarray, scounts: np.ndarray,
                      device: Optional[torch.device] = None):
        """(int64 keys, uint8 weights) of a sorted sample on ``device``
        (default: the engine's first device). Weights clamp at H-1
        losslessly (histogram bins clamp there), so they cross to the
        device as uint8."""
        dev = self.device if device is None else device
        with wait("sweep.upload"):
            skey = torch.from_numpy(np.ascontiguousarray(
                skmers_u64, np.uint64).view(np.int64)).to(dev)
            sw = torch.from_numpy(np.minimum(scounts, HIST_H - 1).astype(
                np.uint8)).to(dev)
        return skey, sw

    # ---- the streamed device-resident sample --------------------------

    def _sorted_device_sample(self, device_view):
        """(keys int64 [n], weights uint8 [n]) of a streamed sample,
        sorted on the device in uint64 order (on ``u64_order``). Only the n
        live keys enter the sort; they are distinct (dedup output), so the
        order equals the host table's."""
        self.counters["device_view_sorts"] += 1
        keys, w = device_view.live()
        skey, order = torch.sort(u64_order(keys), stable=True)
        return u64_order(skey, inplace=True), w[order]

    def _device_slices(self, skey: torch.Tensor):
        """Per-chunk (starts, ends) into a sample sorted in uint64 order,
        computed on the device: searchsorted of the chunk edges in that
        order, clipped to n by construction (only live keys are sorted)."""
        e = self._edges
        sk = u64_order(skey)
        starts = torch.searchsorted(sk, e[:, 0].contiguous(), side="left")
        ends = torch.searchsorted(sk, e[:, 1].contiguous(), side="right")
        return starts, ends

    def _device_view_slices(self, skey: torch.Tensor):
        """[start, end) per chunk of a device-sorted sample (one small
        fetch), equal to slice_sample on the host-sorted table."""
        starts, ends = self._device_slices(skey)
        with wait("sweep.slices"):
            se = torch.stack((starts, ends), dim=1).cpu().numpy()
        return [(int(s), int(e)) for s, e in se]

    @spanned("sweep")
    def hist_device_stream(self, skey: torch.Tensor,
                           w_dev: Optional[torch.Tensor] = None,
                           n_matches: Optional[int] = None,
                           cs: Optional[int] = None):
        """All-device histogram of a sorted unique sample (``skey`` int64
        [n] in uint64 order, ``w_dev`` its weights): chunk offsets on the
        device, per-chunk slices gathered on the device, nothing crosses to
        the host.

        With ``w_dev`` None, ``skey`` is an occurrence stream instead (any
        shape and order, repeats encode multiplicity, -1 pads anywhere): it
        is folded on the device first (``fold_stream``), as the JAX
        package folds its sorted stream (sylph_tpu/tpu/grange.py:1142).

        Returns (hist [g_eff*H+1] device int64, probe, P): ``probe`` is a
        device int64 [2] of (summed conservation differences, longest
        chunk slice); the histogram is exact iff probe[0] == 0 and
        probe[1] <= P. The slice length P and the cell capacity are sized
        from the sample's mean per chunk (after the fold, the distinct
        keys; an explicit ``cs`` overrides the cell capacity, as a retry
        after a failed probe asks), and the code compaction from an
        estimated match count (``n_matches``, else twice the sample), not
        from the measured slices, so no fetch gates the dispatch; a
        violation shows in the probe and callers take the per-chunk path
        instead.

        Where the engine can see that it is safe (``_graph_ready``), the
        sweep after the fold is one replay of a CUDA graph captured for
        the sample's ``sweep_shape`` (the first sample of a shape runs
        eagerly and captures it); elsewhere it runs eagerly. Either way the
        results are fresh tensors."""
        self._require_one_device("hist_device_stream")
        if w_dev is None:
            skey, w_dev = fold_stream(skey)
        shape = self.sweep_shape(int(skey.shape[0]), n_matches, cs)
        if self._graph_ready():
            hist, probe = self._replay(shape, skey, w_dev)
        else:
            self.counters["stream_eager_sweeps"] += 1
            hist, probe = self._stream_sweep(shape, skey,
                                             w_dev.to(torch.int32))
        return hist, probe, shape.P

    def sweep_shape(self, t: int, n_matches: Optional[int] = None,
                    cs: Optional[int] = None) -> SweepShape:
        """The SweepShape of hist_device_stream over ``t`` sorted unique
        keys: plan_stream's P and CS, and the capr and repack passes that
        its density gives one chunk (``_code_plan``, as the chunk loop
        computes them)."""
        P, CS, density = self.plan_stream(t, n_matches, cs)
        capr, steps = _code_plan(density, self.gidx.B, self.gidx.CI)
        return SweepShape(P, CS, capr, steps, _tcap(t))

    def _stream_sweep(self, shape: SweepShape, skey: torch.Tensor,
                      sw: torch.Tensor, out: Optional[torch.Tensor] = None):
        """(hist, probe) of hist_device_stream after the fold: the device
        slices, the chunk loop (B1, B2/B4, B3) and the histogram (into
        ``out`` where given, see hist_from_codes) and probe, issued on the
        current stream with no host sync, so it can be captured. ``skey``
        (int64, uint64 order) and ``sw`` (int32) may carry a KEY_PAD / 0
        tail."""
        gidx = self.gidx
        G = self._GE
        n_chunks = len(gidx.chunk_keys)
        with span("sweep.plan"):
            starts, ends = self._device_slices(skey)
            lane = torch.arange(shape.P, device=skey.device)
        codes_parts, diag_parts = [], []
        nxt = self._chunk_dev(0) if n_chunks else None
        for i in range(n_chunks):
            with span("sweep.chunk"):
                cur = nxt            # prefetch overlaps the previous join
                nxt = self._chunk_dev(i + 1) if i + 1 < n_chunks else None
                c_key, c_w = chunk_slice(skey, sw, starts[i], ends[i], lane)
                ikey, gidg = cur
                cod, nl, nc, wlost = _chunk_codes(
                    ikey, gidg, c_key, c_w, int(gidx.bases[i]),
                    width=gidx.width, B=gidx.B, CS=shape.CS, n_genomes=G,
                    plan=(shape.capr, shape.steps), nt=gidx.nt,
                    subwidth=gidx.subwidth, ov=gidx.ov)
                codes_parts.append(cod)
                diag_parts.append((nl - nc).abs() + wlost)
        with span("sweep.hist"):
            hist = hist_from_codes(torch.cat(codes_parts), n_genomes=G,
                                   out=out)
            probe = torch.stack((torch.stack(diag_parts).sum(),
                                 (ends - starts).max()))
        return hist, probe

    def _graph_ready(self) -> bool:
        """Whether a stream sweep replays a captured graph: on a CUDA
        device, one device and process, every chunk resident (a streamed
        upload is host work inside the loop) and no heavy-run index."""
        return (self.device.type == "cuda" and self._one_device()
                and len(self._dev_chunks) == len(self.gidx.chunk_keys)
                and self.gidx.n_heavy == 0)

    def _replay(self, shape: SweepShape, skey: torch.Tensor,
                w_dev: torch.Tensor):
        """(hist, probe) of _stream_sweep on the sample staged into the
        static inputs: a replay of the graph of ``shape`` where the engine
        keeps one, copied out of the static outputs so that the next
        replay cannot overwrite them; else the eager sweep that captures
        the graph for the samples of that shape that follow. Past
        _GRAPHS_MAX kept graphs a new shape runs eagerly, uncaptured."""
        if shape not in self._graphs and len(self._graphs) >= _GRAPHS_MAX:
            self.counters["stream_eager_sweeps"] += 1
            return self._stream_sweep(shape, skey, w_dev.to(torch.int32))
        with span("sweep.replay"):
            bufs = self._graph_in.get(shape.Tcap)
            if bufs is None:
                bufs = self._graph_in[shape.Tcap] = tuple(
                    torch.empty(shape.Tcap, dtype=dt, device=self.device)
                    for dt in (torch.int64, torch.int32))
            keys, w = bufs
            stage_sample(keys, w, skey, w_dev)
            hit = self._graphs.get(shape)
            if hit is None:
                return self._capture(shape, keys, w)
            graph, held = hit
            graph.replay()
            _cuda.count_launches(held)
            self.counters["stream_graph_replays"] += 1
            hist, probe = self._graph_out
            return hist[:self._GE * HIST_H + 1].clone(), probe.clone()

    def _capture(self, shape: SweepShape, keys: torch.Tensor,
                 w: torch.Tensor):
        """(hist, probe) of _stream_sweep at ``shape`` on the static inputs
        ``keys`` and ``w``, run eagerly on the current stream (which also
        builds and loads every kernel outside the capture), then the graph
        of the same work, captured on the engine's side stream into its
        one memory pool and kept for the next sample of this shape.

        The capture neither synchronizes nor empties the allocator's cache
        (as ``torch.cuda.graph`` does on entry), so the host never waits
        on the device here. Its launches run only in a replay: they count
        in the graph's own record (``_cuda.recording_launches``, this
        thread only), which each replay adds. Every temporary of the
        capture is freed before it ends and the outputs live outside the
        pool, so the graphs that share the pool may replay in any order."""
        with span("sweep.capture"):
            if self._graph_out is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._graph_side = torch.cuda.Stream(self.device)
                self._graph_out = (
                    torch.empty(self._GE * HIST_H + SENT_BINS,
                                dtype=torch.int64, device=self.device),
                    torch.empty(2, dtype=torch.int64, device=self.device))
            result = self._stream_sweep(shape, keys, w)
            hist, probe = self._graph_out
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._graph_side), \
                    _cuda.recording_launches() as held:
                graph.capture_begin(pool=self._graph_pool,
                                    capture_error_mode="thread_local")
                try:
                    probe.copy_(self._stream_sweep(shape, keys, w,
                                                   out=hist)[1])
                finally:
                    graph.capture_end()
        self.counters["stream_graph_captures"] += 1
        self._graphs[shape] = (graph, held)
        return result

    def graph_buffers(self) -> list:
        """The device tensors the engine keeps for its captured stream
        sweeps: a static input pair a Tcap and the static outputs (the
        graphs' temporaries are in their pool, reserved, not allocated)."""
        out = [t for pair in self._graph_in.values() for t in pair]
        return out + list(self._graph_out or ())

    def candidate_mask_stream(self, device_view, mask_fn,
                              n_matches: Optional[int] = None):
        """([G] bool candidate mask, measured match total) of a streamed
        sample through one all-device sweep (sort, device offsets,
        hist_device_stream) and ONE fetch of probe + match total + mask.
        None when the index has heavy runs (their marker bins expand on
        the host) or the probe shows a capacity violation (callers then
        take hists(device_view=...))."""
        if self.gidx.n_heavy or device_view is None or \
                not self._one_device():
            return None
        G, H = self._GE, HIST_H
        skey, w = self._sorted_device_sample(device_view)
        hist, probe, P = self.hist_device_stream(skey, w,
                                                 n_matches=n_matches)
        mask = mask_fn(hist[:G * H])
        matches = hist[:G * H].sum().reshape(1)
        with wait("sweep.mask"):
            v = torch.cat([probe, matches, mask.to(torch.int64)]
                          ).cpu().numpy()
        if int(v[0]) != 0 or int(v[1]) > P:
            log.debug("mask stream conservation check failed; the "
                      "per-chunk path follows")
            self.counters["mask_stream_rejected"] += 1
            return None
        self.counters["mask_stream_masks"] += 1
        return v[3:].astype(bool), int(v[2])

    # ---- batched sweeps: S samples, one pass over the index --------------

    def upload_tables(self, tables):
        """([S, T] int64 keys with a KEY_PAD tail, [S, T] uint8 weights,
        live lengths) of S sorted (kmers, counts) tables on the engine's
        device; T is the next power of two (>= 1024) of the longest, as the
        JAX package pads them."""
        n_live = [int(k.size) for k, _ in tables]
        T = _tcap(max(n_live))
        keys = torch.full((len(tables), T), KEY_PAD, dtype=torch.int64,
                          device=self.device)
        w = torch.zeros((len(tables), T), dtype=torch.uint8,
                        device=self.device)
        for s, (k, c) in enumerate(tables):
            kd, wd = self.upload_sample(k, c)
            keys[s, :n_live[s]] = kd
            w[s, :n_live[s]] = wd
        return keys, w, n_live

    def plan_stream(self, t: int, n_matches: Optional[int] = None,
                    cs: Optional[int] = None):
        """(P, CS, density) of hist_device_stream over ``t`` sorted unique
        keys: the slice length P and the cell capacity from the mean per
        chunk (``cs`` overrides the capacity), the code density from the
        live codes per chunk, the measured match count (x1.25) when the
        caller knows it, else the 2x-unique worst case."""
        gidx = self.gidx
        n_chunks = len(gidx.chunk_keys)
        mean = t / n_chunks
        P = _quantize_p(1.3 * mean + 6.0 * np.sqrt(mean) + 64, t)
        if cs is not None:
            CS = cs
        elif gidx.nt > 1:
            CS = cell_cs(max(1, t // n_chunks), gidx.B * gidx.nt)
        else:
            CS = sample_cs(max(1, t // n_chunks), gidx.B, granularity=8)
        est_codes = ((1.25 * n_matches) if n_matches is not None
                     else 2.0 * t) / n_chunks
        density = min(1.0, max(est_codes, 512.0)
                      / max(1, gidx.B * gidx.CI))
        return P, CS, density

    def plan_batched(self, n_live: List[int], T: int,
                     cs: Optional[int] = None):
        """(P, CS, density) of a batched sweep over tables of these live
        lengths padded to T, sized from the largest as sylph_tpu's
        hist_device_stream_batched sizes pre-folded tables (grange.py:
        1269-1302): P from the longest table per chunk, CS from it too
        (the tables are unique) unless ``cs`` overrides it, the code
        density over S*B*CI from 2x its unique count per chunk."""
        gidx = self.gidx
        n_chunks = len(gidx.chunk_keys)
        n = max(max(n_live), 1)
        mean = n / n_chunks
        P = _quantize_p(1.3 * mean + 6.0 * np.sqrt(mean) + 64, T)
        if cs is not None:
            CS = cs
        elif gidx.nt > 1:
            CS = cell_cs(max(1, n // n_chunks), gidx.B * gidx.nt)
        else:
            CS = sample_cs(max(1, n // n_chunks), gidx.B, granularity=8)
        S = len(n_live)
        density = min(1.0, max(S * 2.0 * n / n_chunks, 512.0)
                      / max(1, S * gidx.B * gidx.CI))
        return P, CS, density

    def batched_slices(self, keys: torch.Tensor, n_live: List[int]):
        """[S, n_chunks] (starts, ends) of every chunk in each row of an
        [S, T] table (live prefix in uint64 order, KEY_PAD tail), searched
        in uint64 order over the row's live prefix. The tail would sort
        last there too (KEY_PAD is u64::MAX, and no kept hash is), so the
        prefix only spares the search the pads."""
        e = self._edges
        lo, hi = e[:, 0].contiguous(), e[:, 1].contiguous()
        rows = [u64_order(keys[s, :n]) for s, n in enumerate(n_live)]
        starts = torch.stack([torch.searchsorted(r, lo, side="left")
                              for r in rows])
        ends = torch.stack([torch.searchsorted(r, hi, side="right")
                            for r in rows])
        return starts, ends

    def hist_device_stream_batched(self, keys: torch.Tensor,
                                   w: torch.Tensor, n_live: List[int],
                                   cs: Optional[int] = None):
        """All-device histograms of S sorted unique tables in ONE sweep of
        the index (sylph_tpu/tpu/grange.py:1242-1350): per chunk S fills
        (B1), one batched compare (B2b, or B4b on dense batches) and one
        repack chain over the sample-tagged stream, then one histogram over
        S*g_eff*H + 1 bins. ``keys``/``w`` are [S, T] as upload_tables
        gives them, ``n_live`` their live lengths.

        Returns (hists [S, g_eff*H] device int64, probe, P): ``probe`` is a
        device int64 [2] of (summed conservation differences, longest chunk
        slice); the histograms are exact iff probe[0] == 0 and probe[1] <=
        P. The port's histogram is exact, so the JAX probe's runs_cap leg
        has no counterpart."""
        self._require_one_device("hist_device_stream_batched")
        gidx = self.gidx
        G = self._GE
        S, T = keys.shape
        P, CS, density = self.plan_batched(n_live, T, cs)
        starts, ends = self.batched_slices(keys, n_live)
        sw = w.to(torch.int32)
        n_chunks = len(gidx.chunk_keys)
        codes_parts, diag = [], []
        nxt = self._chunk_dev(0) if n_chunks else None
        for i in range(n_chunks):
            cur = nxt                # prefetch overlaps the previous join
            nxt = self._chunk_dev(i + 1) if i + 1 < n_chunks else None
            c_key, c_w = _gather_slices(keys, sw, starts[:, i], ends[:, i],
                                        P)
            ikey, gidg = cur
            cod, nl, nc, wlost = _chunk_codes_batched(
                ikey, gidg, c_key, c_w, int(gidx.bases[i]),
                width=gidx.width, B=gidx.B, CS=CS, n_genomes=G,
                density=density, nt=gidx.nt, subwidth=gidx.subwidth,
                ov=gidx.ov)
            codes_parts.append(cod)
            diag.append((nl - nc).abs() + wlost)
        # codes are (s*G + gid)*H + mult: one histogram over S*G bins
        hist = hist_from_codes(torch.cat(codes_parts), n_genomes=S * G)
        probe = torch.stack((torch.stack(diag).sum(),
                             (ends - starts).max()))
        return hist[:S * G * HIST_H].view(S, G * HIST_H), probe, P

    def hists_batched(self, tables) -> np.ndarray:
        """[S, G, HIST_H] exact histograms of S sorted, unique (kmers,
        counts) tables through ONE batched sweep (sylph_tpu/tpu/grange.py:
        1386-1422). Each row is folded (heavy-run markers) and gets its
        spill probe; a batch that fails its conservation check falls back
        to per-sample sweeps, which are exact on their own."""
        self._require_one_device("hists_batched")
        self.counters["batched_sweeps"] += 1
        keys, w, n_live = self.upload_tables(tables)
        hist, probe, P = self.hist_device_stream_batched(keys, w, n_live)
        with wait("sweep.probe"):
            v = probe.cpu().numpy()
        if int(v[0]) != 0 or int(v[1]) > P:
            log.info("batched grange sweep of %d samples failed its "
                     "conservation check (difference %d, longest slice %d, "
                     "P %d); per-sample sweeps follow", len(tables),
                     int(v[0]), int(v[1]), P)
            self.counters["batched_rejected"] += 1
            return np.stack([self.hists(k, c) for k, c in tables])
        with wait("sweep.fetch"):
            rows = hist.cpu().numpy()
        out = np.stack([self._fold_heavy(r) for r in rows])
        if self.gidx.spill_kmers.size:
            for s, (k, c) in enumerate(tables):
                out[s] += self._spill_hist(np.asarray(k, np.uint64), c)
        return out

    @spanned("sweep.chunks")
    def hists(self, skmers_u64: Optional[np.ndarray],
              scounts: Optional[np.ndarray], mask_fn=None,
              device_view=None, table_fn=None) -> np.ndarray:
        """[G, HIST_H] exact (clamped) per-genome multiplicity histograms
        of a sorted, unique (kmers, counts) sample table: of every chunk,
        or under a process span of the chunks this process owns (the spill
        list then counts in process 0 only).

        ``mask_fn`` (device [G*H] histogram -> device [G] bool) skips the
        [G, H] fetch for the prefilter: when the engine has one device and
        no span, every chunk passed its conservation check and the index
        has no heavy runs, only the [G] mask comes back (callers detect it
        by ndim). The mask covers grid counts only; spill hits are the
        caller's to OR in.

        With a ``device_view`` (a streamed device-resident sample) on a
        one-device engine the device sorts and slices the sample; the host
        table is needed only for the spill side channel, so callers may
        pass None and a ``table_fn`` returning (sorted_kmers_u64, counts)
        on demand, which lets the host sort overlap the device sweep. On
        several devices the host table is sliced and each chunk's slice
        goes to the chunk's device, as the JAX package does."""
        gidx = self.gidx
        G, H = self._GE, HIST_H
        self.counters["hists_sweeps"] += 1
        tbl = [skmers_u64, scounts]

        def _tbl():
            if tbl[0] is None:
                tbl[0], tbl[1] = table_fn()
            return tbl[0], tbl[1]

        t0 = time.perf_counter()
        smp_on = {}             # device -> the sample's (keys, weights)
        if device_view is not None and len(self.devices) == 1:
            skey, sw = self._sorted_device_sample(device_view)
            slices, P, CS, density = self._plan_slices(
                self._device_view_slices(skey))
            smp_on[self.device] = (skey, sw)
        else:
            sk = np.ascontiguousarray(_tbl()[0], np.uint64)
            slices, P, CS, density = self.plan(sk)
            device_view = None

        def sample_on(dev):
            if dev not in smp_on:
                smp_on[dev] = self.upload_sample(sk, _tbl()[1], device=dev)
            return smp_on[dev]
        log.debug("[timing] grange hists: sample sort + slices %.3f s "
                  "(%s)", time.perf_counter() - t0,
                  "device" if device_view is not None else "host")

        t0 = time.perf_counter()
        parts = []    # (device index, codes, |nl-nc| + w_lost, nl, (i, smp))
        owned = [i for i in range(len(slices)) if self._owns(i)]
        nxt = self._chunk_dev(owned[0]) if owned else None
        for oi, i in enumerate(owned):
            s, e = slices[i]
            cur = nxt
            nxt = (self._chunk_dev(owned[oi + 1]) if oi + 1 < len(owned)
                   else None)
            di = i % len(self.devices)
            smp = _pad_slice(*sample_on(self.devices[di]), s, e, P)
            ikey, gidg = cur
            cod, nl, nc, wlost = _chunk_codes(
                ikey, gidg, *smp, int(gidx.bases[i]), width=gidx.width,
                B=gidx.B, CS=CS, n_genomes=G, density=density, nt=gidx.nt,
                subwidth=gidx.subwidth, ov=gidx.ov)
            parts.append((di, cod, (nl - nc).abs() + wlost, nl, (i, smp)))
        # one small fetch per device for its chunks' conservation checks
        # (the true live counts ride along: they size the final
        # re-compaction)
        by_dev = {}
        for j, p in enumerate(parts):
            by_dev.setdefault(p[0], []).append(j)
        bad, live = set(), {}
        for js in by_dev.values():
            with wait("sweep.probe"):
                fetched = torch.stack([torch.stack(parts[j][2:4])
                                       for j in js]).cpu().numpy()
            for j, (dv, nlv) in zip(js, fetched):
                live[j] = int(nlv)
                if dv != 0:
                    bad.add(j)
        codes_by_dev = {}
        for j, p in enumerate(parts):
            if j not in bad:
                codes_by_dev.setdefault(p[0], []).append(p[1])
        live_total = sum(v for j, v in live.items() if j not in bad)
        t1 = time.perf_counter()
        log.debug("[timing] grange hists: %d chunks on %d device(s) "
                  "dispatch+sync %.3f s, %d failed conservation",
                  len(owned), len(by_dev), t1 - t0, len(bad))

        def _recompact(cc):
            """The per-chunk streams are sized by a conservative 4*P
            estimate; one more repack chain at the measured density
            collapses the padding before the histogram (a single count
            verifies it; on a mismatch the original stream is kept)."""
            n = int(cc.shape[0])
            if n < _RECOMPACT_MIN or live_total * 8 >= n:
                return cc
            d_true = max(live_total / n, 1e-6)
            dq = min(0.25, 2.0 ** np.ceil(np.log2(d_true)) * 2.0)
            cc2 = _repack_codes(cc, _repack_chain(n, dq))
            with wait("sweep.recompact"):
                n2 = int((cc2 != SENT).sum())
            return cc2 if n2 == live_total else cc

        if mask_fn is not None and not bad and gidx.n_heavy == 0 \
                and self._one_device():
            if not codes_by_dev:
                return np.zeros(gidx.n_genomes, bool)
            (good,) = codes_by_dev.values()
            cc = _recompact(torch.cat(good) if len(good) > 1 else good[0])
            h_dev = hist_from_codes(cc, n_genomes=G)
            mask = mask_fn(h_dev[:G * H])
            with wait("sweep.mask"):
                return mask.cpu().numpy()
        # one bincount per device over its good code streams, summed here
        hist = np.zeros(G * H + 1, np.int64)
        for good in codes_by_dev.values():
            cc = torch.cat(good) if len(good) > 1 else good[0]
            if len(codes_by_dev) == 1:
                cc = _recompact(cc)
            h = hist_from_codes(cc, n_genomes=G)
            with wait("sweep.fetch"):
                hist += h.cpu().numpy()
        for j in sorted(bad):
            # compaction or cell-capacity overflow: lossless redo at 4x
            # the sample capacity, on the chunk's own device
            ci, smp = parts[j][4]
            ikey, gidg = self._chunk_dev(ci)
            h = _chunk_hist_lossless(
                ikey, gidg, *smp, int(gidx.bases[ci]), width=gidx.width,
                B=gidx.B, CS=4 * CS, n_genomes=G)
            with wait("sweep.fetch"):
                hist += h.cpu().numpy()
        out = self._fold_heavy(hist)
        if gidx.spill_kmers.size and self._owns_sides():
            out += self._spill_hist(*_tbl())
        log.debug("[timing] grange hists: hist fetch+fold %.3f s",
                  time.perf_counter() - t1)
        return out

    # this process's partial histogram under a span, by the name of the
    # multi-process call site (sylph_tpu/tpu/grange.py:1470); sum the
    # processes' partials with ``merge_process_hists``
    partial_hists = hists


def merge_process_hists(partial: np.ndarray) -> np.ndarray:
    """The sum of every process's partial grange histogram ([G, 64] int64,
    from ``partial_hists``), summed over the process group on the host
    (sylph_tpu/tpu/grange.py:1731-1745); the identity outside a group."""
    return allreduce_sum(partial)
