"""The work of the bucket regime's kernel launches (drivers/bucket_join.py)
from this run's data, by chip_smoke.py's formulas for the kernel table's
B1 (whole range) and B5' rows, in the count forms of arith.py (held equal
to the tensor forms by perfbench/tests):

  B1 at nt = 1 (csrc/fill.cu, a launch a chunk): 12 B a live sample entry
     read and 12 B a slot of the [B, CS] bucket grids written; no SM
     clocks counted (chip_smoke.py's row is bound by bytes)
  B5' (csrc/join.cu in count mode, a launch a chunk): ``_join_bytes`` of
     the chunk's [B, CI] key grid against the [B, CS] weight grid, with
     the [B, CI] int32 counts written; COMPARE_CLOCKS a compare of a live
     index slot with a live lane of its bucket (``_live_compares`` at
     nt = 1)

A chunk's ``Layout`` is the geometry its engine laid it out in
(``gpu/bucket_join.py::BucketedIndex``), which the driver records at load.
"""

from typing import NamedTuple

import torch

from . import arith


class Layout(NamedTuple):
    B: int
    CI: int
    width: int
    slots: torch.Tensor      # [B] int64 live index slots a bucket


def lanes(keys: torch.Tensor, lay: Layout, CS: int) -> torch.Tensor:
    """[B] live lanes of a sample's bucket grids: its distinct keys in each
    bucket, up to CS (the fill drops the rest)."""
    b = ((keys >> 32) & 0xFFFFFFFF) // lay.width
    n = torch.bincount(b[b < lay.B], minlength=lay.B).cpu()
    return torch.clamp(n, max=CS)


def fill_launch(n_live: int, lay: Layout, CS: int):
    """(bytes, clocks) of one B1 launch at nt = 1 over a chunk."""
    return n_live * 12 + lay.B * CS * 12, 0


def join_launch(lay: Layout, live: torch.Tensor, CS: int):
    """(bytes, clocks) of one B5' launch over a chunk, ``live`` [B] the
    sample's live lanes a bucket."""
    nbytes = arith.join_bytes_counts(lay.B * lay.CI, lay.B * CS,
                                     int(live.sum()), 0, lay.B * lay.CI * 4)
    clocks = arith.live_compares_counts(
        lay.slots[:, None], torch.zeros(lay.B, dtype=torch.int64),
        live[:, None]) * arith.COMPARE_CLOCKS
    return nbytes, clocks
