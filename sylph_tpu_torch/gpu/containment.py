"""Merge-regime containment and the flattened host index (counterpart of
sylph_tpu/tpu/containment.py::merge_join_counts and _bincount, of the
vmapped join of engine/device_exec.py, and of
tpu/pipeline.py::HostIndex/build_host_index).

The JAX package joins index and sample with one sort of their union and
run totals of the sample weights, built from sorts and scans because
gathers are slow on the TPU. On the GPU a gather is cheap: the sample table
is sorted once and each index k-mer's count is the weight between its two
``torch.searchsorted`` bounds, the same numbers in index order. The
function is plain torch on whatever device its tensors lie on (it is XLA,
not a Pallas kernel, in the JAX package).

The JAX package also avoids the TPU's slow scatter with a sort-based
bincount; on the GPU and the CPU ``torch.bincount`` is exact and cheap.
"""

from typing import List, NamedTuple, Optional

import numpy as np
import torch


class HostIndex(NamedTuple):
    """Flattened genome index on the host: genomes contiguous, in order."""
    keys: np.ndarray        # [M] int64 k-mer bits; padding rows hold 0
    genome_ids: np.ndarray  # [M] int32; padding rows get id n_genomes
    n_kmers: np.ndarray     # [G] int32
    n_genomes: int


def build_host_index(kmer_arrays: List[np.ndarray],
                     pad_multiple: int = 8) -> HostIndex:
    """Concatenate per-genome u64 sketch k-mer arrays into one [M] index,
    padded to a multiple of ``pad_multiple``; pad rows are key 0 with
    genome id G, so they fall out of every histogram and genome slice."""
    G = len(kmer_arrays)
    sizes = np.array([a.size for a in kmer_arrays], dtype=np.int32)
    total = int(sizes.sum())
    M = max(pad_multiple, -(-total // pad_multiple) * pad_multiple)
    keys = np.zeros(M, np.int64)
    if total:
        keys[:total] = np.concatenate(kmer_arrays).astype(
            np.uint64).view(np.int64)
    gids = np.full(M, G, np.int32)
    gids[:total] = np.repeat(np.arange(G, dtype=np.int32), sizes)
    return HostIndex(keys, gids, sizes, G)


def merge_join_counts(idx_key: torch.Tensor, smp_key: torch.Tensor,
                      smp_weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """[M] int32: for each index key, the summed weight of the sample
    entries with an equal key (1 each without weights), in index order.

    The sample may be unsorted and hold repeats. Its -1 pads sort first in
    int64 (the JAX SENT sorts last); their weight is 0, so they add nothing
    even to an index key of -1."""
    smp_key = smp_key.reshape(-1)
    if smp_weights is None:
        smp_weights = torch.ones(smp_key.shape, dtype=torch.int64,
                                 device=smp_key.device)
    sk, order = torch.sort(smp_key, stable=True)
    cw = torch.zeros(sk.numel() + 1, dtype=torch.int64, device=sk.device)
    torch.cumsum(smp_weights.reshape(-1)[order].to(torch.int64), 0,
                 out=cw[1:])
    lo = torch.searchsorted(sk, idx_key, right=False)
    hi = torch.searchsorted(sk, idx_key, right=True)
    return (cw[hi] - cw[lo]).to(torch.int32)


def merge_join_counts_batched(idx_key: torch.Tensor, smp_keys: torch.Tensor,
                              smp_weights: torch.Tensor) -> torch.Tensor:
    """[S, M] int32: merge_join_counts of the index against each row of
    [S, T] sample tables, in one call (the counterpart of the JAX
    package's vmapped merge join, engine/device_exec.py:58-68). One join
    per row: on an H100 a sort along the rows and searches batched over
    them took twice as long as the rows' single joins (15.2 against 7.8 ms
    for four 2^22-slot tables against 8.4M index slots, chip_smoke.py
    check (o))."""
    return torch.stack([merge_join_counts(idx_key, k, w)
                        for k, w in zip(smp_keys, smp_weights)])


def _bincount(seg: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[n_bins] int64 histogram of bin ids in [0, n_bins)."""
    return torch.bincount(seg.reshape(-1).to(torch.int64),
                          minlength=n_bins)[:n_bins]
