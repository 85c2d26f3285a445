"""FracMinHash read seeding on the device (counterpart of
sylph_tpu/tpu/seeding.py and pallas_seeding.py::seed_hashes_pallas, B7).

Behavioral spec: sylph's scalar seeding loop (src/seeding.rs:86-146): for
every k-mer window take ``min(forward, revcomp)`` by 64-bit compare, hash
it with the bugged Wang mix, keep iff ``hash < u64::MAX / c``.

Reads arrive in the 2-bit packed wire format: [N, L/16] words, 16 bases a
word, LSB-first (engine/device_sketch.py::_pack16_rows), held as int32
tensors with the uint32 bits. A hash is one int64 with the uint64 bits
(gpu/keys.py). Torch has no unsigned 64-bit shifts or compares on the CPU,
so the plain versions use wrapping int64 adds, masked logical right shifts
and a sign-flipped threshold compare; the CUDA kernel (csrc/seed.cu) uses
uint64_t throughout.

Also here, as in pallas_seeding.py: the row repacks B11 (``repack_rows``,
the counterpart of ``repack_pallas``) and B12 (``repack1_rows``, of
``repack1_pallas``), which condense a pad-coded stream row by row. They
run csrc/repack.cu's kernel, B8's int64 and B3's int32 instance.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _cuda
from .bucket_fill import launch_repack, repack_windows_plain

_INT64_MIN = -(1 << 63)


def _check_ck(c: int, k: int) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in 1..31, got {k}")
    if c < 1:
        raise ValueError(f"c must be >= 1, got {c}")


def threshold(c: int) -> int:
    """u64::MAX / c (src/seeding.rs:108) as a Python int."""
    return ((1 << 64) - 1) // c


def _as_i64(u: int) -> int:
    """The int64 with the bits of a uint64 value."""
    return u - (1 << 64) if u >= (1 << 63) else u


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mm_hash64(key: torch.Tensor) -> torch.Tensor:
    """The reference's bugged Wang mix (src/seeding.rs:4-15) on int64 bit
    patterns: the first step is ~(key + (key << 21))."""
    key = ~(key + (key << 21))
    key = key ^ _lsr(key, 24)
    key = key + (key << 3) + (key << 8)          # key * 265
    key = key ^ _lsr(key, 14)
    key = key + (key << 2) + (key << 4)          # key * 21
    key = key ^ _lsr(key, 28)
    return key + (key << 31)


def unpack_bases(packed: torch.Tensor) -> torch.Tensor:
    """[N, L/16] packed words -> [N, L] int64 2-bit codes
    (pipeline.py::unpack_bases)."""
    N, nw = packed.shape
    sh = torch.arange(0, 32, 2, device=packed.device, dtype=torch.int64)
    w = packed.to(torch.int64) & 0xFFFFFFFF
    return ((w.unsqueeze(-1) >> sh) & 3).reshape(N, nw * 16)


def _pow2_parts(m: int):
    """m as descending powers of two (31 -> [16, 8, 4, 2, 1])."""
    return [1 << b for b in range(m.bit_length() - 1, -1, -1) if m >> b & 1]


def canonical_kmers(b: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical k-mers (int64, < 2^62) of every window of a [N, L] int64
    code batch -> [N, L-k+1], by the log-doubling composition of
    tpu/seeding.py::_build_mers on whole int64 k-mers:
    F_{a+b}[i] = F_a[i] << 2b | F_b[i+a], R_{a+b}[i] = R_a[i] | R_b[i+a] << 2a.
    Canonical = min(forward, revcomp), forward on ties."""
    L = b.shape[1]
    pf, pr = {1: b}, {1: 3 - b}
    p = 1
    while p * 2 <= k:
        f, r = pf[p], pr[p]
        n = f.shape[1] - p
        pf[2 * p] = (f[:, :n] << (2 * p)) | f[:, p:]
        pr[2 * p] = r[:, :n] | (r[:, p:] << (2 * p))
        p *= 2
    parts = _pow2_parts(k)
    size = parts[0]
    accf, accr = pf[size], pr[size]
    for q in parts[1:]:
        n = L - size - q + 1
        accf = (accf[:, :n] << (2 * q)) | pf[q][:, size:size + n]
        accr = accr[:, :n] | (pr[q][:, size:size + n] << (2 * size))
        size += q
    W = L - k + 1
    # both k-mers are < 2^62, so the signed min is the uint64 min
    return torch.minimum(accf[:, :W], accr[:, :W])


def seed_hashes(bases: torch.Tensor, lengths: torch.Tensor, *, c: int,
                k: int):
    """(hash, keep), each [N, L-k+1], for a [N, L] batch of 2-bit codes:
    tpu/seeding.py::seed_hashes in int64. keep is True iff the window lies
    inside its read (pos + k <= lengths) AND the hash clears
    ``u64::MAX / c``."""
    _check_ck(c, k)
    N, L = bases.shape
    W = L - k + 1
    if W < 1:
        raise ValueError(f"padded read length {L} < k {k}")
    h = mm_hash64(canonical_kmers(bases.to(torch.int64), k))
    thr = _as_i64(threshold(c)) ^ _INT64_MIN
    keep = (h ^ _INT64_MIN) < thr
    pos = torch.arange(W, device=bases.device)
    keep &= (pos + k)[None, :] <= lengths.to(torch.int64)[:, None]
    return h, keep


def compact_by_position(hash_: torch.Tensor, keep: torch.Tensor, cap: int,
                        want_lanes: bool = False):
    """Per-row compaction that PRESERVES position order: each row's first
    ``cap`` kept hashes, left-packed, pad -1 (the JAX package's sort by
    lane key). A per-row rank by cumsum and one scatter; dropped entries
    all land in a spare column, which is cut off. With ``want_lanes`` the
    survivors' window lanes come back too (pad -1), as genome sketching
    needs positions for the spacing filter."""
    R, W = hash_.shape
    kp = keep.to(torch.int64)
    rank = torch.cumsum(kp, dim=1) - kp
    sel = keep & (rank < cap)
    col = torch.where(sel, rank, cap)
    out = torch.full((R, cap + 1), -1, dtype=torch.int64,
                     device=hash_.device)
    out.scatter_(1, col, torch.where(sel, hash_, -1))
    if not want_lanes:
        return out[:, :cap]
    lane = torch.arange(W, device=hash_.device).expand(R, W)
    lanes = torch.full((R, cap + 1), -1, dtype=torch.int64,
                       device=hash_.device)
    lanes.scatter_(1, col, torch.where(sel, lane, -1))
    return out[:, :cap], lanes[:, :cap]


def seed_packed_plain(packed: torch.Tensor, lengths: torch.Tensor, *,
                      c: int, k: int):
    """Plain version of B7: (hash int64, keep bool), each [N, L], from the
    packed batch; windows past L read bases as 0 (their keep is False)."""
    bases = F.pad(unpack_bases(packed), (0, k - 1))
    return seed_hashes(bases, lengths, c=c, k=k)


def seed_packed(packed: torch.Tensor, lengths: torch.Tensor, *, c: int,
                k: int):
    """B7: per-window canonical k-mer hash and FracMinHash keep of a packed
    read batch ([N, L/16] int32 words, [N] int32 lengths) -> (hash int64
    [N, L], keep bool [N, L]); the same contract as the plain version, bit
    for bit."""
    _check_ck(c, k)
    N, nw = packed.shape
    L = nw * 16
    if packed.device.type == "cpu":
        return seed_packed_plain(packed, lengths, c=c, k=k)
    dev = packed.device
    _cuda.require(packed, "packed", torch.int32, 2, dev)
    _cuda.require(lengths, "lengths", torch.int32, 1, dev)
    if lengths.shape[0] != N:
        raise ValueError(f"lengths {tuple(lengths.shape)} for {N} rows")
    hash_ = torch.empty((N, L), dtype=torch.int64, device=dev)
    keep = torch.empty((N, L), dtype=torch.bool, device=dev)
    lib = _cuda.library("seed")
    with torch.cuda.device(dev):
        rc = lib.seed_launch(
            _cuda.ptr(packed), _cuda.ptr(lengths), ctypes.c_int64(N),
            ctypes.c_int(L), ctypes.c_int(k), ctypes.c_uint64(threshold(c)),
            _cuda.ptr(hash_), _cuda.ptr(keep), _cuda.stream_ptr(packed))
    _cuda.check(lib, rc, "seed_launch")
    _cuda.count_launch("B7_seed")
    return hash_, keep


# ---- B11 and B12: row repacks -------------------------------------------

def _check_rows(row: int, cap: int) -> None:
    """The Pallas wrappers' geometry check (pallas_seeding.py:362-364,
    403-405)."""
    if cap % 128 != 0 or row % 128 != 0 or cap > row:
        raise ValueError(f"row/cap must be 128-multiples with cap <= row "
                         f"(got row={row} cap={cap})")


def _rows_padded(n: int, row: int, tr_max: int) -> int:
    """Rows of ``row`` slots over an n-slot stream, padded to a multiple
    of the Pallas row block tr = min(tr_max, rows)."""
    rows = -(-n // row)
    tr = min(tr_max, rows)
    return -(-rows // tr) * tr if rows else 0


def _b12_block(row: int) -> int:
    """B12's row-block cap: 256 rows, fewer for wide rows (2^19 slots a
    block, at least 8)."""
    return min(256, max(8, (1 << 19) // row))


def repack_rows_plain(keys: torch.Tensor, *, row: int,
                      cap: int) -> torch.Tensor:
    """Plain version of B11: [rows_pad, cap] int64, row r the live (non
    -1) keys of stream slots [r*row, (r+1)*row) in order, overflow past
    ``cap`` dropped, -1 after; rows padded to a multiple of min(256,
    rows)."""
    _check_rows(row, cap)
    keys = keys.reshape(-1)
    nrow = _rows_padded(keys.numel(), row, 256)
    return repack_windows_plain(keys, nrow, row, cap).view(nrow, cap)


def repack1_rows_plain(v: torch.Tensor, *, row: int,
                       cap: int) -> torch.Tensor:
    """Plain version of B12: B11 on an int32 code stream (pad -1 =
    0xFFFFFFFF), rows padded to a multiple of min(256, max(8, 2^19 // row),
    rows)."""
    _check_rows(row, cap)
    v = v.reshape(-1)
    nrow = _rows_padded(v.numel(), row, _b12_block(row))
    return repack_windows_plain(v, nrow, row, cap).view(nrow, cap)


def repack_rows(keys: torch.Tensor, *, row: int, cap: int) -> torch.Tensor:
    """B11: condense a flat int64 key stream (pad -1) row by row ->
    [rows_pad, cap]; see ``repack_rows_plain``. The port's form of
    repack_pallas's (hi, lo) pair streams, as B8 is of repack2_flat's: only
    the key -1 is a pad, so a key whose high word is 0xFFFFFFFF and whose
    low word is not is kept (the Pallas kernel drops it; ROADMAP C)."""
    _check_rows(row, cap)
    keys = keys.reshape(-1)
    if keys.device.type == "cpu":
        return repack_rows_plain(keys, row=row, cap=cap)
    nrow = _rows_padded(keys.numel(), row, 256)
    return launch_repack(keys, nrow, row, cap, torch.int64,
                         "repack64_launch", "B11_repack_rows").view(nrow, cap)


def repack1_rows(v: torch.Tensor, *, row: int, cap: int) -> torch.Tensor:
    """B12: condense a flat int32 code stream (pad -1) row by row ->
    [rows_pad, cap]; see ``repack1_rows_plain``."""
    _check_rows(row, cap)
    v = v.reshape(-1)
    if v.device.type == "cpu":
        return repack1_rows_plain(v, row=row, cap=cap)
    nrow = _rows_padded(v.numel(), row, _b12_block(row))
    return launch_repack(v, nrow, row, cap, torch.int32, "repack_launch",
                         "B12_repack1_rows").view(nrow, cap)
