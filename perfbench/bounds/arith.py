"""The least time a kernel needs on one NVIDIA H100, from the work its
inputs need (a frozen copy of chip_smoke.py's bound arithmetic: its
H100 constants, ``_sm_clocks``, ``COMPARE_CLOCKS``, ``WINDOW_CLOCKS``,
``_live_compares``, ``_live_windows``, ``_join_bytes``;
each count-form helper below is held equal to its tensor form by
perfbench/tests).

A bound is the larger of the bytes the launch must move at the HBM rate
and the SM clocks its instructions need at the SM clock rate; a
roofline share is that bound over the profiler's time of the launch.
"""

H100_BYTES_PER_S = 3.35e12     # HBM3, SXM data sheet
# SM clocks a second: 132 SMs at the 1.98 GHz boost (Hopper whitepaper);
# the data sheet has no integer rate outside the tensor cores
H100_SM_CLOCKS_PER_S = 132 * 1.98e9


def _sm_clocks(alu=0.0, fma=0.0, either=0.0, quarter=0.0, other=0.0):
    """The least SM clocks that issue this many 32-bit lane-instructions,
    each counted by the pipe that must run it. A Hopper SM dispatches 4
    warp instructions (128 lanes) a clock (whitepaper: 32 threads a clock
    a partition); its ALU pipe (SHF, LOP3, ISETP, SEL) and its FMA pipe
    (IMAD) each take 64 lanes a clock; ``either`` is work that either pipe
    can do (an add or a shift-and-add: IADD3 or LEA on the ALU pipe, IMAD
    on the FMA pipe); ``quarter`` (POPC, BREV) runs at 16 a clock (CUDA C
    programming guide, throughput of arithmetic instructions, 9.0);
    ``other`` (SHFL, VOTE) only takes issue slots."""
    return max(alu / 64, fma / 64, quarter / 16,
               (alu + fma + either + quarter + other) / 128)


# a 64-bit equality and its conditional add in join.cu's lane loop: two
# ISETP (low word, then high word chained) and one predicated add
COMPARE_CLOCKS = _sm_clocks(alu=2, either=1)
# a k-mer window of the seeding kernels, in the cheapest form of the pair
# code (k >= 17: two adjacent windows a lane), per window: ALU 29, FMA 8,
# either 4, quarter 2, other 2.5 (chip_smoke.py's account of each)
WINDOW_CLOCKS = _sm_clocks(alu=29, fma=8, either=4, quarter=2, other=2.5)


def _live_compares(ikey, dw, nt: int = 1, tile: int = 0) -> int:
    """Equality tests a compare kernel needs: per index row, its live slots
    times the live lanes they are compared with (tiled layout: column tile
    t against lane group t, the overflow columns against every lane)."""
    import torch
    il = (ikey != -1).to(torch.int64)
    ll = (dw > 0).to(torch.int64)
    if nt <= 1:
        return int((il.sum(1) * ll.sum(1)).sum())
    cs = ll.shape[1] // nt
    n = (il[:, nt * tile:].sum(1) * ll.sum(1)).sum()
    for t in range(nt):
        n += (il[:, t * tile:(t + 1) * tile].sum(1)
              * ll[:, t * cs:(t + 1) * cs].sum(1)).sum()
    return int(n)


def _live_windows(lens, k: int) -> int:
    """k-mer windows in rows of these lengths."""
    import torch
    return int(torch.clamp(lens.to(torch.int64) - (k - 1), min=0).sum())


def _join_bytes(ikey, dw, out_bytes: int, counts=None) -> int:
    """Bytes a join.cu launch must move: the key grid once, the weight
    grid(s), 8 B for each live lane's key, 4 B of gid for each slot whose
    count is > 0 (code modes: ``counts`` given) and the output as
    written."""
    n = ikey.numel() * 8 + dw.numel() * 4 + int((dw != 0).sum()) * 8
    if counts is not None:
        n += int((counts > 0).sum()) * 4
    return n + out_bytes


# ---- count forms: the same arithmetic on counts the run already holds ----

def live_compares_counts(tile_slots, over_slots, lanes) -> int:
    """``_live_compares`` from counts: ``tile_slots`` [B, nt] live index
    slots of each cell's column tile, ``over_slots`` [B] live overflow
    slots, ``lanes`` [B, nt] live sample lanes of each cell (flat layout:
    nt = 1 and no overflow)."""
    return int((tile_slots * lanes).sum() + (over_slots * lanes.sum(1)).sum())


def join_bytes_counts(grid_slots: int, lanes: int, live_lanes: int,
                      matched: int, out_bytes: int) -> int:
    """``_join_bytes`` from counts: the key grid's slots, the weight grid's
    lanes, its live lanes and the index slots matched."""
    return grid_slots * 8 + lanes * 4 + live_lanes * 8 + matched * 4 \
        + out_bytes


def bound_s(nbytes: float, clocks: float):
    """(least seconds, which bound: "bytes" or "operations")."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = clocks / H100_SM_CLOCKS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
