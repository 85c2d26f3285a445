"""Fused seed-and-pack kernels B6, B9 and B10 (counterpart of
sylph_tpu/tpu/pallas_seeding.py::seed_pack_pallas, seed_pack_pallas_t and
seed_compact_pallas).

Each seeds every k-mer window of a batch of reads given as 2-bit codes
(values 0..3) with their lengths, as B7 does (canonical k-mer, bugged Wang
mix, keep iff ``hash < u64::MAX / c`` and ``i + k <= len``), and packs each
read's surviving hashes in window order, int64 keys with pad -1
(gpu/keys.py):

  seed_pack     B6   [N, L] -> [N, 128]: the first min(128, n) survivors
                     of each read, then -1 (``lanes`` cuts the width)
  seed_pack_t   B9   [L, N], one read per column -> [cap_rows, N]: the same
                     per column, cut at cap_rows = min(L, ceil((4L/c+8)/8)*8)
  seed_compact  B10  [N, L] -> [N, 128]: at most cap = min(128, 4L/c + 8)
                     survivors a read, lanes cap..127 -1; any k in 1..31

The Pallas kernels pack with butterfly routing networks; csrc/seed_pack.cu
writes each survivor at its rank, one row kernel with a capacity argument
for B6 and B10 (a warp a read, a grid of the resident blocks striding over
the reads: ``row_grid``) and one column kernel for B9 (a block a tile of
128 read columns: ``col_blocks``). On a CPU tensor each wrapper runs its
plain version (B7's plain seeding, gpu/seeding.py::seed_hashes, then a
per-row rank); on a CUDA tensor it launches its kernel (uint8 codes, int32
lengths) or raises. Lengths past L count as L.
"""

import ctypes
import functools

import torch

from . import _cuda
from .seeding import compact_by_position, seed_hashes, threshold

CAP_LANES = 128        # B6/B10 output width
BLOCK_ROWS = 256       # Pallas row block of B6/B10: N % 256 or N < 256
T_LANES = 512          # Pallas column block of B9
ROW_WARPS = 8          # csrc/seed_pack.cu: reads a row-kernel block takes
COL_TILE = 128         # read columns a column-kernel block takes
COL_STAGE = 32         # output rows it stages in shared memory


def compact_cap(L: int, c: int) -> int:
    """B10's per-read capacity min(128, 4L/c + 8)."""
    return min(CAP_LANES, 4 * L // c + 8)


def cap_rows_t(L: int, c: int) -> int:
    """B9's per-read capacity: 4L/c + 8 rounded up to 8, at most L."""
    return min(L, -(-(4 * L // c + 8) // 8) * 8)


def row_grid(n: int, resident: int) -> int:
    """Blocks of the row kernel (B6, B10) for ``n`` reads: a warp a read,
    ROW_WARPS a block, at most the ``resident`` blocks the card holds at
    once, which then stride over the reads."""
    return min(-(-n // ROW_WARPS), resident)


def col_blocks(n: int) -> int:
    """Blocks of the column kernel (B9) for ``n`` reads: a block a tile of
    COL_TILE read columns (it walks L in pieces of 256 bases and stages
    its first COL_STAGE output rows in shared memory)."""
    return -(-n // COL_TILE)


def _check(c: int, k: int, k_min: int) -> None:
    if not k_min <= k <= 31:
        raise ValueError(f"k must be in {k_min}..31, got {k}")
    if c < 1:
        raise ValueError(f"c must be >= 1, got {c}")


def _check_block(n: int, block: int) -> None:
    """The Pallas grids tile reads in blocks of min(block, n)."""
    rows = min(block, n)
    if rows and n % rows:
        raise ValueError(f"N ({n}) must be a multiple of {rows}")


def _survivors(bases: torch.Tensor, lengths: torch.Tensor, c: int, k: int,
               cap: int) -> torch.Tensor:
    """[N, cap] int64: each row's first ``cap`` survivors, window order."""
    N, L = bases.shape
    if L < k:
        return torch.full((N, cap), -1, dtype=torch.int64,
                          device=bases.device)
    h, keep = seed_hashes(bases, lengths, c=c, k=k)
    return compact_by_position(h, keep, cap).contiguous()


def seed_pack_plain(bases: torch.Tensor, lengths: torch.Tensor, *, c: int,
                    k: int, lanes: int = CAP_LANES) -> torch.Tensor:
    """Plain version of B6: [N, lanes] first survivors of each read."""
    return _survivors(bases, lengths, c, k, lanes)


def seed_compact_plain(bases: torch.Tensor, lengths: torch.Tensor, *,
                       c: int, k: int) -> torch.Tensor:
    """Plain version of B10: B6 cut to ``compact_cap`` survivors a read,
    still CAP_LANES wide."""
    N, L = bases.shape
    out = torch.full((N, CAP_LANES), -1, dtype=torch.int64,
                     device=bases.device)
    cap = compact_cap(L, c)
    out[:, :cap] = _survivors(bases, lengths, c, k, cap)
    return out


def seed_pack_t_plain(bases_t: torch.Tensor, lengths: torch.Tensor, *,
                      c: int, k: int) -> torch.Tensor:
    """Plain version of B9: [cap_rows, N] survivors, one read per column."""
    L, N = bases_t.shape
    return _survivors(bases_t.t(), lengths, c, k,
                      cap_rows_t(L, c)).t().contiguous()


def _launch(entry: str, kname: str, bases: torch.Tensor,
            lengths: torch.Tensor, n: int, L: int, k: int, c: int,
            out: torch.Tensor, *caps, grid: int) -> torch.Tensor:
    dev = bases.device
    _cuda.require(bases, "bases", torch.uint8, 2, dev)
    _cuda.require(lengths, "lengths", torch.int32, 1, dev)
    if lengths.shape[0] != n:
        raise ValueError(f"lengths {tuple(lengths.shape)} for {n} reads")
    lib = _cuda.library("seed_pack")
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            _cuda.ptr(bases), _cuda.ptr(lengths), ctypes.c_int64(n),
            ctypes.c_int(L), ctypes.c_int(k), ctypes.c_uint64(threshold(c)),
            *[ctypes.c_int(x) for x in caps], _cuda.ptr(out),
            ctypes.c_int64(grid), _cuda.stream_ptr(bases))
    _cuda.check(lib, rc, entry)
    _cuda.count_launch(kname)
    return out


def seed_pack_occupancy(kind: str = "rows") -> dict:
    """What the card reports for a launch of csrc/seed_pack.cu's row
    (``"rows"``: B6, B10) or column kernel (``"cols"``: B9) on the current
    device (card only); see ``_cuda.occupancy``."""
    if kind not in ("rows", "cols"):
        raise ValueError(f"kind must be 'rows' or 'cols', got {kind!r}")
    return _cuda.occupancy(_cuda.library("seed_pack"), "seed_pack_occupancy",
                           ctypes.c_int(kind == "cols"))


@functools.cache
def _resident_rows(dev: torch.device) -> int:
    """Row-kernel blocks resident on ``dev`` at once (worked out once per
    device)."""
    with torch.cuda.device(dev):
        per_sm = seed_pack_occupancy("rows")["ctas_per_sm"]
    return per_sm * torch.cuda.get_device_properties(dev).multi_processor_count


def _launch_rows(kname: str, bases: torch.Tensor, lengths: torch.Tensor,
                 c: int, k: int, cap: int, width: int) -> torch.Tensor:
    """The row kernel: [N, width] with at most ``cap`` survivors a row."""
    N, L = bases.shape
    if bases.data_ptr() % 16:
        raise ValueError("bases: rows must start 16-byte aligned")
    out = torch.empty((N, width), dtype=torch.int64, device=bases.device)
    return _launch("seed_pack_launch", kname, bases, lengths, N, L, k, c,
                   out, cap, width,
                   grid=row_grid(N, _resident_rows(bases.device)))


def seed_pack(bases: torch.Tensor, lengths: torch.Tensor, *, c: int, k: int,
              lanes: int = CAP_LANES) -> torch.Tensor:
    """B6: [N, L] codes, [N] int32 lengths -> [N, lanes] int64, each row
    the read's first min(lanes, n) survivors in window order, then -1.
    ``lanes`` = 128 is the Pallas kernel's output; the pipeline asks for its
    own capacity and is spared writing the rest. Needs L % 128 == 0,
    17 <= k <= 31 and N a multiple of min(256, N), as the Pallas wrapper."""
    N, L = bases.shape
    if L % 128:
        raise ValueError(f"L must be a multiple of 128, got {L}")
    _check(c, k, 17)
    _check_block(N, BLOCK_ROWS)
    if not 1 <= lanes <= CAP_LANES:
        raise ValueError(f"lanes must be in 1..{CAP_LANES}, got {lanes}")
    if bases.device.type == "cpu":
        return seed_pack_plain(bases, lengths, c=c, k=k, lanes=lanes)
    return _launch_rows("B6_seed_pack", bases, lengths, c, k, lanes, lanes)


def seed_compact(bases: torch.Tensor, lengths: torch.Tensor, *, c: int,
                 k: int) -> torch.Tensor:
    """B10: [N, L] codes -> [N, 128] int64 with at most
    min(128, 4L/c + 8) survivors a read (lanes past it -1); any k in
    1..31. Needs L % 128 == 0 and N a multiple of min(256, N)."""
    N, L = bases.shape
    if L % 128:
        raise ValueError(f"L must be a multiple of 128, got {L}")
    _check(c, k, 1)
    _check_block(N, BLOCK_ROWS)
    if bases.device.type == "cpu":
        return seed_compact_plain(bases, lengths, c=c, k=k)
    return _launch_rows("B10_seed_compact", bases, lengths, c, k,
                        compact_cap(L, c), CAP_LANES)


def seed_pack_t(bases_t: torch.Tensor, lengths: torch.Tensor, *, c: int,
                k: int) -> torch.Tensor:
    """B9: [L, N] codes, one read per column -> [cap_rows, N] int64, column
    r the read's first min(cap_rows, n) survivors in window order, then -1
    (``cap_rows_t``). Needs L % 8 == 0, 17 <= k <= 31 and N a multiple of
    min(512, N), as the Pallas wrapper."""
    L, N = bases_t.shape
    if L % 8:
        raise ValueError(f"L must be a multiple of 8, got {L}")
    _check(c, k, 17)
    _check_block(N, T_LANES)
    if bases_t.device.type == "cpu":
        return seed_pack_t_plain(bases_t, lengths, c=c, k=k)
    cap_rows = cap_rows_t(L, c)
    out = torch.empty((cap_rows, N), dtype=torch.int64, device=bases_t.device)
    return _launch("seed_pack_t_launch", "B9_seed_pack_t", bases_t, lengths,
                   N, L, k, c, out, cap_rows, grid=col_blocks(N))
