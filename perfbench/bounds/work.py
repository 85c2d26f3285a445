"""The work a kernel launch of this run needs, from this run's data (the
reads, the index layout the benchmark made, the reference's sketch and
join), whatever implements the kernel:

  B6 (seed-and-pack, csrc/seed_pack.cu) a launch a batch: the batch's
     codes and lengths read once, 8 B a surviving hash written, and
     WINDOW_CLOCKS a k-mer window inside a read
  B2 (compare and compact codes, csrc/join.cu) a launch a chunk: the
     chunk's key grid read once, 12 B a live sample lane (its weight and
     key), 4 B of genome id read and 4 B of code written a matched index
     slot, and COMPARE_CLOCKS a compare of a live
     index slot with a live lane of its cell (the tile's lanes, or every
     lane of the bucket for an overflow column)
"""

import torch

from . import arith


def seed_pack_launch(n_reads: int, row_len: int, lengths: torch.Tensor,
                     survivors: float, k: int):
    """(bytes, clocks) of one B6 launch over a batch."""
    nbytes = n_reads * row_len + n_reads * 4 + survivors * 8
    return nbytes, arith._live_windows(lengths, k) * arith.WINDOW_CLOCKS


def cell_lanes(keys: torch.Tensor, geo) -> torch.Tensor:
    """[n_chunks, B, cells] distinct sample keys in each cell of a grange
    geometry (gen/grange_index.py); keys past the last chunk fall out."""
    hi = (keys >> 32) & 0xFFFFFFFF
    span = geo.B * geo.width
    chunk = hi // span
    local = hi - chunk * span
    cell = (local // geo.width) * geo.cells
    if geo.nt > 1:
        cell = cell + torch.clamp((local % geo.width) // geo.subwidth,
                                  max=geo.nt - 1)
    ok = chunk < geo.n_chunks
    n = geo.n_chunks * geo.B * geo.cells
    return torch.bincount(chunk[ok] * geo.B * geo.cells + cell[ok],
                          minlength=n).view(geo.n_chunks, geo.B, geo.cells)


def join_codes_launch(grid_slots: int, tile_slots: torch.Tensor,
                      over_slots: torch.Tensor, lanes: torch.Tensor,
                      matched: int):
    """(bytes, clocks) of one B2 launch over a chunk: ``tile_slots``
    [B, cells] and ``over_slots`` [B] live index slots, ``lanes``
    [B, cells] live sample lanes, ``matched`` index slots the sample
    holds (one code each)."""
    live = int(lanes.sum())
    nbytes = arith.join_bytes_counts(grid_slots, live, live, matched,
                                     matched * 4)
    return nbytes, arith.live_compares_counts(tile_slots, over_slots,
                                              lanes) * arith.COMPARE_CLOCKS
