"""The frozen bound arithmetic against chip_smoke.py's, on fixed inputs,
and its count forms against its tensor forms."""

import pytest
import torch

from perfbench.bounds import arith, work
from perfbench.gen import grange_index as gi

chip_smoke = pytest.importorskip("chip_smoke")


def _grids(seed, B=64, nt=4, tile=32, ov=16, cs=8):
    g = torch.Generator().manual_seed(seed)
    CI = nt * tile + ov
    ikey = torch.randint(0, 1 << 40, (B, CI), generator=g)
    ikey[torch.rand((B, CI), generator=g) < 0.3] = -1
    dw = torch.randint(0, 3, (B, nt * cs), generator=g, dtype=torch.int32)
    return ikey, dw, nt, tile


@pytest.mark.parametrize("seed", range(4))
def test_constants_and_functions_equal_chip_smoke(seed):
    assert arith.H100_BYTES_PER_S == chip_smoke.H100_BYTES_PER_S
    assert arith.H100_SM_CLOCKS_PER_S == chip_smoke.H100_SM_CLOCKS_PER_S
    assert arith.COMPARE_CLOCKS == chip_smoke.COMPARE_CLOCKS
    assert arith.WINDOW_CLOCKS == chip_smoke.WINDOW_CLOCKS
    for args in [(1, 2, 3, 4, 5), (29, 8, 4, 2, 2.5), (0, 64, 0, 0, 0)]:
        assert arith._sm_clocks(*args) == chip_smoke._sm_clocks(*args)
    ikey, dw, nt, tile = _grids(seed)
    counts = torch.randint(0, 2, ikey.shape)
    for n, t in ((1, 0), (nt, tile)):
        assert arith._live_compares(ikey, dw, n, t) == \
            chip_smoke._live_compares(ikey, dw, n, t)
    assert arith._join_bytes(ikey, dw, 4096, counts) == \
        chip_smoke._join_bytes(ikey, dw, 4096, counts)
    lens = torch.randint(0, 300, (100,))
    assert arith._live_windows(lens, 31) == chip_smoke._live_windows(lens, 31)


@pytest.mark.parametrize("seed", range(4))
def test_count_forms_equal_tensor_forms(seed):
    ikey, dw, nt, tile = _grids(seed)
    cs = dw.shape[1] // nt
    il = (ikey != -1).to(torch.int64)
    tile_slots = torch.stack([il[:, t * tile:(t + 1) * tile].sum(1)
                              for t in range(nt)], 1)
    over = il[:, nt * tile:].sum(1)
    lanes = torch.stack([(dw[:, t * cs:(t + 1) * cs] > 0).sum(1)
                         for t in range(nt)], 1)
    assert arith.live_compares_counts(tile_slots, over, lanes) == \
        arith._live_compares(ikey, dw, nt, tile)
    counts = torch.randint(0, 2, ikey.shape)
    assert arith.join_bytes_counts(
        ikey.numel(), dw.numel(), int((dw != 0).sum()),
        int((counts > 0).sum()), 4096) == arith._join_bytes(
            ikey, dw, 4096, counts)


def test_cell_lanes_counts_each_key_in_its_cell():
    geo = gi.geometry(64, 2048, 200, 1 << 14, 1024, 4)
    keys = torch.cat([gi.flat_block(geo, i, 0, geo.B, "cpu")[0]
                      for i in range(geo.n_chunks)])
    lanes = work.cell_lanes(keys, geo)
    want = torch.stack([gi.cell_counts(geo, i, 0, geo.B, "cpu")
                        for i in range(geo.n_chunks)])
    assert torch.equal(lanes, want)


def test_bound_picks_the_larger():
    t, which = arith.bound_s(3.35e12, 0)
    assert (t, which) == (1.0, "bytes")
    t, which = arith.bound_s(0, arith.H100_SM_CLOCKS_PER_S * 2)
    assert (t, which) == (2.0, "operations")
