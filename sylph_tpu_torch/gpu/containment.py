"""Merge-regime containment and the flattened host index (counterpart of
sylph_tpu/tpu/containment.py::merge_join_counts, merge_join_hist,
compact_rows and _bincount, of the vmapped and the sharded joins of
engine/device_exec.py, and of tpu/pipeline.py::HostIndex/build_host_index).

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

from ..utils.timing import spanned, wait
from .keys import KEY_PAD, from_pair_np

_INT64_MIN = -(1 << 63)


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


def host_index_from_jax(hi: np.ndarray, lo: np.ndarray,
                        genome_ids: np.ndarray, n_kmers: np.ndarray,
                        n_genomes: int) -> HostIndex:
    """The port's HostIndex of the JAX package's (sylph_tpu/tpu/pipeline.py
    HostIndex fields): (hi, lo) uint32 pairs become int64 keys; its pad rows
    are (0, 0) with id n_genomes, the port's pads too."""
    return HostIndex(from_pair_np(hi, lo),
                     np.asarray(genome_ids, np.int32),
                     np.asarray(n_kmers, np.int32), int(n_genomes))


def compact_rows(hash_: torch.Tensor, keep: torch.Tensor, row: int,
                 cap: int) -> torch.Tensor:
    """Fixed-capacity compaction of surviving hashes: the window stream cut
    into rows of ``row`` entries (the tail padded with dropped windows),
    dropped windows masked to the pad, each row sorted ascending in uint64
    order with pads last, the first ``cap`` columns kept -> [ceil(n/row),
    cap] int64. A row with more than ``cap`` survivors drops its largest.

    The JAX package sorts (hi, lo) pairs with the (SENT, SENT) pad last;
    in int64 the pad -1 sorts first and, for c = 1, real hashes may have the
    top bit set, so the rows sort on ``key ^ INT64_MIN`` (uint64 order, the
    pad becoming INT64_MAX) and flip back."""
    flat = torch.where(keep.reshape(-1), hash_.reshape(-1), KEY_PAD)
    n = flat.numel()
    rows = -(-n // row)
    m = torch.full((rows * row,), KEY_PAD, dtype=torch.int64,
                   device=flat.device)
    m[:n] = flat
    s = torch.sort((m ^ _INT64_MIN).view(rows, row), dim=1).values
    return s[:, :cap] ^ _INT64_MIN


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


def shard_index(keys: np.ndarray, devices) -> List[torch.Tensor]:
    """The [M] index keys cut into len(devices) equal shards, shard d on
    ``devices[d]`` (the index's ('ip',) sharding of
    sylph_tpu/engine/device_exec.py:242-281); M must divide evenly."""
    n = len(devices)
    if keys.size % n:
        raise ValueError(f"{keys.size} index slots do not shard evenly over "
                         f"{n} devices")
    return [torch.from_numpy(part).to(dev)
            for part, dev in zip(np.split(keys, n), devices)]


def merge_join_counts_sharded(shards: List[torch.Tensor],
                              smp_key: torch.Tensor,
                              smp_weights: torch.Tensor) -> np.ndarray:
    """[M] int32 host counts of the sharded index: each shard joins the
    same sample table on its own device, and the counts concatenate in
    shard order, equal to merge_join_counts of the whole index."""
    outs = [merge_join_counts(sh, smp_key.to(sh.device),
                              smp_weights.to(sh.device)) for sh in shards]
    return np.concatenate([o.cpu().numpy() for o in outs])


def merge_join_counts_sharded_batched(shards: List[torch.Tensor],
                                      smp_keys: torch.Tensor,
                                      smp_weights: torch.Tensor
                                      ) -> np.ndarray:
    """[S, M] int32 host counts of [S, T] sample tables against the
    sharded index (the batched form, device_exec.py:272-277): per shard
    merge_join_counts_batched on its device, concatenated along M."""
    outs = [merge_join_counts_batched(sh, smp_keys.to(sh.device),
                                      smp_weights.to(sh.device))
            for sh in shards]
    return np.concatenate([o.cpu().numpy() for o in outs], axis=1)


@spanned("join")
def merge_join_hist(idx_key: torch.Tensor, gids: torch.Tensor,
                    smp_key: torch.Tensor, *, n_genomes: int,
                    n_buckets: int) -> torch.Tensor:
    """[G, H] int32 per-genome multiplicity histograms of a sample
    occurrence stream (``smp_key``, any order and shape, repeats encode
    multiplicity, -1 pads) against the index (``idx_key`` [M], ``gids``
    [M], pad rows with id >= G): hist[g, j] counts genome g's k-mers seen j
    times in the sample, j clamped to H - 1 (JAX merge_join_hist)."""
    return genome_hist(gids, merge_join_counts(idx_key, smp_key),
                       n_genomes, n_buckets)


def genome_hist(gids: torch.Tensor, counts: torch.Tensor, n_genomes: int,
                n_buckets: int) -> torch.Tensor:
    """[G, H] int32: per index slot, its genome id and its sample count
    (same shapes) -> hist[g, j] = slots of genome g counted j times, j
    clamped to H - 1; slots with an id >= G fall out."""
    G, H = n_genomes, n_buckets
    g = gids.to(torch.int64)
    seg = torch.where(g < G, g * H + counts.to(torch.int64).clamp(max=H - 1),
                      G * H)
    with wait("join.bincount"):
        h = _bincount(seg, G * H + 1)
    return h[:G * H].view(G, H).to(torch.int32)


def _bincount(seg: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[n_bins] int64 histogram of bin ids in [0, n_bins)."""
    return torch.bincount(seg.reshape(-1).to(torch.int64),
                          minlength=n_bins)[:n_bins]
