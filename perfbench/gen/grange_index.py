"""A GTDB-class genome index in the grange layout, made on the device from
slot counters (a frozen plain-torch copy of the flat and hash-tiled
generators of sylph_tpu_torch/gpu/synth_index.py, without its duplication
mode).

Every quantity is a function of a global slot counter:

    value(slot)  = mm_hash64(counter ^ SALT_V)
    hash_hi      = chunk_base + bucket*width [+ tile*subwidth]
                   + value_hi % span
    hash_lo      = value_lo
    gid(slot)    = mm_hash64(counter ^ SALT_G)_lo % G
    count(cell)  = cbase + mm_hash64(cell ^ SALT_C)_lo % cmod

The genomes with an id below ``plantable`` are the ones a sample can hold:
each of their keys is redrawn from attempt counters (``value`` of
``counter ^ (a << 33)``, a = 1, 2, ...) until it inverts to a canonical
31-mer, as every k-mer of a real sketch does, so reads can carry all of
them. The keys of the other genomes stay as the port's generator makes
them (about one in eight inverts); no read carries them.

So the same index can be read two ways: ``chunk_layout`` lays a chunk out
as the port's build rule does ([B, CI] key and genome-id grids, int64 keys
with pad -1, genome ids with pad G), and ``flat_block`` enumerates the live
slots of a run of buckets straight from the counters, with no layout. The
plants and the reference read the flat view; the port is handed the
layout. The hash space [0, u64::MAX / c) is cut into n_chunks ranges of B
buckets x width; nt > 1 splits a bucket into nt hash sub-ranges of
``tile`` columns each plus OV shared overflow columns.
"""

import math
from dataclasses import dataclass

import torch

from .hashing import as_i64, lsr, mm_hash64, usable

SALT_V = 0x9E3779B97F4A7C15
SALT_G = 0xC2B2AE3D27D4EB4F
SALT_C = 0x165667B19E3779F9
OV = 128                      # overflow columns of the tiled layout
KEY_PAD = -1
ROWS = 4096                   # buckets made at once (bounds transients)
ATTEMPTS = (8, 16, 32, 64, 128, 256, 512)   # redraws a round, per key
_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Geometry:
    G: int
    n_chunks: int
    B: int                    # buckets a chunk
    CI: int                   # columns a bucket
    width: int                # hash_hi units a bucket
    nt: int                   # hash sub-ranges a bucket (1: flat layout)
    tile: int                 # columns a sub-range (nt > 1)
    stride: int               # counters a cell
    subwidth: int
    cbase: int                # a cell's live count: cbase + h % cmod
    cmod: int
    plantable: int = 0        # genomes [0, plantable) hold usable keys

    @property
    def cells(self) -> int:
        """Cells a bucket: nt sub-ranges, or the bucket itself."""
        return max(self.nt, 1)

    def base(self, chunk: int) -> int:
        """The chunk's first hash_hi."""
        return chunk * self.B * self.width

    def edges(self, chunk: int):
        """(first, last) uint64 hash the chunk covers."""
        lo = self.base(chunk) << 32
        return lo, ((self.base(chunk + 1)) << 32) - 1


def geometry(G: int, KPG: int, c: int, chunk_slots: int, target_mean: int,
             nt: int, plantable: int = 0) -> Geometry:
    """The layout of G*KPG index k-mers: chunks of about chunk_slots live
    slots, power-of-two buckets of about target_mean slots, a bucket's
    width so that every hash stays below u64::MAX / c; the keys of genomes
    [0, plantable) redrawn until usable."""
    M = G * KPG
    n_chunks = max(1, -(-M // chunk_slots))
    slots = -(-M // n_chunks)
    B = 1 << max(0, int(math.ceil(math.log2(max(1, slots // target_mean)))))
    mean = slots / B
    spread = max(1, int(3.5 * math.sqrt(mean)))
    CI = -(-int(mean + spread) // 128) * 128
    width = max(1, ((((1 << 64) - 1) // c) >> 32) // (n_chunks * B))
    if nt <= 1:
        geo = Geometry(G, n_chunks, B, CI, width, 1, CI, CI, width,
                       max(0, int(mean) - spread), 2 * spread + 1,
                       min(plantable, G))
    else:
        mean_t = mean / nt
        spread_t = max(1, int(3.5 * math.sqrt(mean_t)))
        tile = 128 * max(1, int(round(mean_t / 128 + 0.25)))
        stride = tile + OV // nt
        geo = Geometry(G, n_chunks, B, nt * tile + OV, width, nt, tile,
                       stride, -(-width // nt), max(0, int(mean_t) - spread_t),
                       2 * spread_t + 1, min(plantable, G))
    top = geo.n_chunks * geo.B * geo.cells * geo.stride
    if top > 1 << 32 or (geo.n_chunks * geo.B + 1) * geo.width > 1 << 32:
        raise ValueError(f"index geometry passes 2^32 counters: {geo}")
    return geo


def _mix(x: torch.Tensor, salt: int) -> torch.Tensor:
    return mm_hash64(x ^ as_i64(salt))


def _lo(h: torch.Tensor) -> torch.Tensor:
    return h & _M32


def cell_counts(geo: Geometry, chunk: int, r0: int, r1: int,
                device) -> torch.Tensor:
    """[r1 - r0, cells] live slots of each cell of buckets [r0, r1)."""
    jg = torch.arange(r0, r1, dtype=torch.int64, device=device)[:, None] \
        + chunk * geo.B
    cell = jg * geo.cells + torch.arange(geo.cells, device=device)[None, :]
    ct = geo.cbase + _lo(_mix(cell, SALT_C)) % geo.cmod
    return torch.clamp(ct, max=geo.stride) if geo.nt > 1 else ct


def _key(geo: Geometry, chunk: int, j, t, v: torch.Tensor) -> torch.Tensor:
    """The key a slot value gives in bucket j (chunk-local), sub-range t."""
    span = geo.width if geo.nt <= 1 else torch.clamp(torch.clamp(
        geo.width - t * geo.subwidth, max=geo.subwidth), min=1)
    hi = geo.base(chunk) + j * geo.width + t * geo.subwidth \
        + lsr(v, 32) % span
    return (hi << 32) | _lo(v)


def _redraw(geo: Geometry, chunk: int, j, t, counter, key, mine):
    """``key`` with each slot in ``mine`` whose key is not usable given the
    key of its first usable attempt a >= 1, in the same bucket and
    sub-range."""
    shape = key.shape
    want = (mine & ~usable(key)).reshape(-1)
    idx = want.nonzero().squeeze(1)
    if idx.numel() == 0:
        return key
    out = key.reshape(-1).clone()
    jj = j.expand(shape).reshape(-1)[idx, None]
    tt = t.expand(shape).reshape(-1)[idx, None]
    cc = counter.expand(shape).reshape(-1)[idx, None]
    a0 = 1
    for n in ATTEMPTS:
        a = torch.arange(a0, a0 + n, dtype=torch.int64,
                         device=key.device)[None, :]
        k = _key(geo, chunk, jj, tt, _mix(cc ^ (a << 33), SALT_V))
        ok = usable(k)
        has = ok.any(1)
        first = torch.argmax(ok.to(torch.int8), 1, keepdim=True)
        out[idx[has]] = k.gather(1, first)[has, 0]
        idx, jj, tt, cc = idx[~has], jj[~has], tt[~has], cc[~has]
        if idx.numel() == 0:
            return out.view(shape)
        a0 += n
    raise RuntimeError(f"{idx.numel()} keys found no usable redraw")


def _values(geo: Geometry, chunk: int, j: torch.Tensor, t: torch.Tensor,
            counter: torch.Tensor):
    """(key, gid) of slot counters in bucket j (chunk-local), sub-range t."""
    gid = _lo(_mix(counter, SALT_G)) % geo.G
    key = _key(geo, chunk, j, t, _mix(counter, SALT_V))
    if geo.plantable:
        key = _redraw(geo, chunk, j, t, counter, key, gid < geo.plantable)
    return key, gid


def flat_block(geo: Geometry, chunk: int, r0: int, r1: int, device):
    """(keys int64, gids int64) of every live slot of buckets [r0, r1) of a
    chunk, enumerated from the counters cell by cell."""
    ct = cell_counts(geo, chunk, r0, r1, device).reshape(-1)
    n = int(ct.sum())
    first = (torch.arange(ct.numel(), dtype=torch.int64, device=device)
             + (chunk * geo.B + r0) * geo.cells) * geo.stride
    starts = torch.cumsum(ct, 0) - ct
    counter = (torch.repeat_interleave(first, ct, output_size=n)
               + torch.arange(n, dtype=torch.int64, device=device)
               - torch.repeat_interleave(starts, ct, output_size=n))
    cell = counter // geo.stride
    j = cell // geo.cells - chunk * geo.B
    t = cell % geo.cells
    return _values(geo, chunk, j, t, counter)


def flat_blocks(geo: Geometry, device, rows: int = ROWS):
    """Every chunk's flat view, in (chunk, keys, gids) blocks of ``rows``
    buckets."""
    for i in range(geo.n_chunks):
        for r0 in range(0, geo.B, rows):
            yield (i, *flat_block(geo, i, r0, min(geo.B, r0 + rows),
                                  device))


def _layout_rows(geo: Geometry, chunk: int, r0: int, r1: int, device):
    """Rows [r0, r1) of a chunk's [B, CI] grids. Flat: a bucket's slots in
    its first count columns. Tiled: columns [t*tile, (t+1)*tile) hold
    sub-range t's first ``tile`` slots, the last OV columns each cell's
    slots past its tile, in cell order."""
    CI, nt, tile = geo.CI, geo.nt, geo.tile
    j = torch.arange(r0, r1, dtype=torch.int64, device=device)[:, None]
    s = torch.arange(CI, dtype=torch.int64, device=device)[None, :]
    jg = j + chunk * geo.B
    ct = cell_counts(geo, chunk, r0, r1, device)
    if nt <= 1:
        live = s < ct
        t = torch.zeros_like(s)
        counter = jg * CI + s
    else:
        R = r1 - r0
        ots = torch.clamp(ct - tile, min=0)
        cums = torch.cat([torch.zeros_like(ots[:, :1]),
                          torch.cumsum(ots, dim=1)], dim=1)
        in_tiles = s < nt * tile
        t_of_s = torch.clamp(s // tile, max=nt - 1)
        ct_sel = ct.gather(1, t_of_s.expand(R, CI))
        live_tile = in_tiles & (s % tile < torch.clamp(ct_sel, max=tile))
        k = s - nt * tile
        tau = torch.zeros((R, CI), dtype=torch.int64, device=device)
        for u in range(1, nt):
            tau += (k >= cums[:, u:u + 1]).to(torch.int64)
        live = live_tile | (~in_tiles & (k < cums[:, nt:nt + 1]))
        t = torch.where(in_tiles, t_of_s, tau)
        s_local = torch.where(in_tiles, s % tile,
                              tile + (k - cums.gather(1, tau)))
        counter = (jg * nt + t) * geo.stride + s_local
    key, gid = _values(geo, chunk, j, t, counter)
    return (torch.where(live, key, KEY_PAD),
            torch.where(live, gid, geo.G).to(torch.int32))


def chunk_layout(geo: Geometry, chunk: int, device):
    """One chunk's (keys [B, CI] int64, gids [B, CI] int32) on ``device``."""
    keys = torch.empty((geo.B, geo.CI), dtype=torch.int64, device=device)
    gids = torch.empty((geo.B, geo.CI), dtype=torch.int32, device=device)
    for r0 in range(0, geo.B, ROWS):
        r1 = min(geo.B, r0 + ROWS)
        keys[r0:r1], gids[r0:r1] = _layout_rows(geo, chunk, r0, r1, device)
    return keys, gids
