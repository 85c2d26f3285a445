"""The one-shot device profiling pipeline (counterpart of
sylph_tpu/tpu/pipeline.py, single device).

Read batches of 2-bit codes -> fused seeding and per-read survivor packing
(B6, or B9 under SYLPH_SEED_T=1, or seeding then a row sort where the
fused kernels do not fit) -> the merge join of the genome index -> per-genome
multiplicity histograms -> batched f32 statistics:

  sketch_batch, sketch_batch_packed   one batch -> (survivor keys, count)
  finish_profile                      stacked survivors -> (hist, stats)
  profile_step                        one batch -> (hist, stats)
  finish_profile_batched              [S, T] samples -> ([S, G, H], stats)

Keys are int64 with pad -1 (gpu/keys.py) where the JAX package returns
(hi, lo) uint32 pairs. Each entry point takes ``device`` (default "cuda";
asking for it without a GPU raises): numpy inputs move there, tensors stay
where they are. ``_sketch_compact`` picks its branch from the shapes alone,
as the JAX package does on its TPU, so a batch gets the same layout on
the CPU (plain versions of the kernels) as on the card.

  make_mesh, make_sharded_profile_step   one batch over a (dp, ip) grid of
                                         ranks -> (hist, stats), replicated

The sharded step runs one rank a device over a ``torch.distributed`` group
its caller creates (utils/distributed.py::init_group): NCCL where each rank
has its own GPU, gloo on the CPU or where ranks share a card. The group's
backend is the caller's choice; the step never switches it.
"""

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..engine.device_sketch import _pack16_rows
from ..kmer.hashing import BYTE_TO_SEQ_NP
from ..utils.distributed import host_collective
from ..utils.timing import span
from .bucket_fill import condense_stream
from .containment import compact_rows, merge_join_hist
from .grange import resolve_device
from .keys import KEY_PAD
from .seed_pack import BLOCK_ROWS, T_LANES, seed_pack, seed_pack_t
from .seeding import seed_hashes, seed_packed, unpack_bases
from .stats import GenomeStats, stats_from_histograms

DEFAULT_BUCKETS = 256  # multiplicities clamp here; stats need median < 30
_ROW = 512             # compaction row width of the fallback

# the transposed fused kernel (B9), opt-in as in the JAX package
_USE_TRANSPOSED_SEED = os.environ.get("SYLPH_SEED_T", "0") == "1"


def compaction_cap(c: int, row: int = _ROW) -> int:
    """Per-row survivor capacity of the fallback: ~4x the FracMinHash
    expectation."""
    return min(row, 4 * row // c + 8)


def _pack_words(codes: torch.Tensor) -> torch.Tensor:
    """[N, L] 2-bit codes -> [N, L/16] int32 words holding the uint32 bits
    of 16 bases, LSB-first (pack_bases_u32 on the device)."""
    N, L = codes.shape
    sh = torch.arange(0, 32, 2, device=codes.device, dtype=torch.int64)
    w = ((codes.view(N, L // 16, 16).to(torch.int64) & 3) << sh).sum(dim=2)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _seed(bases: torch.Tensor, lengths: torch.Tensor, *, c: int, k: int):
    """(hash, keep) of every window: B7 (``seed_packed``, [N, L], the codes
    packed into words on the device) where the JAX package launches its
    Pallas seeding, the torch log-doubling seeding ([N, L-k+1]) elsewhere.
    Both agree on their common columns."""
    N, L = bases.shape
    if L % 128 == 0 and (N % BLOCK_ROWS == 0 or N < BLOCK_ROWS):
        return seed_packed(_pack_words(bases), lengths, c=c, k=k)
    return seed_hashes(bases, lengths, c=c, k=k)


def _seed_route(N: int, L: int, c: int, k: int) -> str:
    """Which kernel ``_sketch_compact`` takes for an [N, L] batch: "B9"
    (under SYLPH_SEED_T=1), "B6", or the "fallback". The fused kernels need
    L % 128 == 0, 16 < k <= 31, c >= 2 and a capacity of 4L/c + 8 <= 128."""
    if L % 128 == 0 and 16 < k <= 31 and c >= 2 and 4 * L // c + 8 <= 128:
        if _USE_TRANSPOSED_SEED and (N % T_LANES == 0 or N < T_LANES):
            return "B9"
        if N % BLOCK_ROWS == 0 or N < BLOCK_ROWS:
            return "B6"
    return "fallback"


def _sketch_compact(bases: torch.Tensor, lengths: torch.Tensor, *, c: int,
                    k: int) -> torch.Tensor:
    """Read batch -> each read's surviving hashes, pad -1: [N, cap] from
    B6, [cap_rows, N] from B9 (one read per column), or the fallback's
    [ceil(N(L-k+1)/512), compaction_cap(c)] row-sorted windows
    (``_seed_route`` picks)."""
    with span("seed.pack"):
        N, L = bases.shape
        bases = bases.to(torch.uint8).contiguous()
        lengths = lengths.to(torch.int32).contiguous()
        route = _seed_route(N, L, c, k)
        if route == "B9":
            return seed_pack_t(bases.t().contiguous(), lengths, c=c, k=k)
        if route == "B6":
            return seed_pack(bases, lengths, c=c, k=k,
                             lanes=min(128, 4 * L // c + 8))
        hash_, keep = _seed(bases, lengths, c=c, k=k)
        W = L - k + 1                   # drop structurally dead columns
        return compact_rows(hash_[:, :W], keep[:, :W], _ROW,
                            compaction_cap(c))


def pack_reads(seqs: List[bytes], length: int,
               pad_multiple: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Pad and stack raw DNA byte strings into a [N, L] 2-bit code batch
    (uint32) and int32 lengths; N is padded to ``pad_multiple`` with
    length-0 rows."""
    n = len(seqs)
    N = max(pad_multiple, -(-n // pad_multiple) * pad_multiple)
    bases = np.zeros((N, length), np.uint32)
    lengths = np.zeros(N, np.int32)
    for i, s in enumerate(seqs):
        arr = np.frombuffer(bytes(s[:length]), dtype=np.uint8)
        bases[i, :arr.size] = BYTE_TO_SEQ_NP[arr]
        lengths[i] = arr.size
    return bases, lengths


def pack_bases_u32(codes: np.ndarray) -> np.ndarray:
    """[N, L] 2-bit codes -> [N, L/16] uint32 words (16 bases, LSB-first),
    the wire format of read batches (0.25 B a base)."""
    if codes.shape[1] % 16 != 0:
        raise ValueError(f"L must be a multiple of 16, got {codes.shape[1]}")
    return _pack16_rows(np.ascontiguousarray(codes, np.uint8))


def _tensor(x, dev: torch.device) -> torch.Tensor:
    """A tensor stays where it is; a numpy array moves to ``dev``, uint32
    and uint64 arrays as the int32 and int64 with the same bits."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _count(keys: torch.Tensor) -> torch.Tensor:
    return (keys != KEY_PAD).sum(dtype=torch.int32)


def sketch_batch(bases, lengths, *, c: int, k: int, device="cuda"):
    """One read batch ([N, L] 2-bit codes, [N] lengths) -> (surviving hash
    keys int64 with pad -1, in ``_sketch_compact``'s layout; their count as
    a 0-d int32). Batches accumulate on the device and ``finish_profile``
    joins them at once, so each genome k-mer joins once a sample."""
    dev = resolve_device(device)
    with span("seed"):
        keys = _sketch_compact(_tensor(bases, dev), _tensor(lengths, dev),
                               c=c, k=k)
        return keys, _count(keys)


def sketch_batch_packed(packed, lengths, *, c: int, k: int, device="cuda"):
    """sketch_batch over the packed wire format ([N, L/16] words holding
    uint32 bits, as int32 or uint32): unpacked on the device, then the
    fused kernel."""
    dev = resolve_device(device)
    with span("seed"):
        with span("seed.unpack"):
            bases = unpack_bases(_tensor(packed, dev)).to(torch.uint8)
        keys = _sketch_compact(bases, _tensor(lengths, dev), c=c, k=k)
        return keys, _count(keys)


def finish_profile(all_keys, idx_key, gids, n_kmers, *, k: int,
                   n_genomes: int, n_buckets: int = DEFAULT_BUCKETS,
                   min_ani: float = 0.95, device="cuda"):
    """Containment: stacked sample survivors (any shape, -1 pads) against
    the index (``idx_key`` [M], ``gids`` [M], ``n_kmers`` [G]) ->
    (hist [G, H] int32, GenomeStats)."""
    dev = resolve_device(device)
    hist = merge_join_hist(_tensor(idx_key, dev), _tensor(gids, dev),
                           _tensor(all_keys, dev), n_genomes=n_genomes,
                           n_buckets=n_buckets)
    st = stats_from_histograms(hist, _tensor(n_kmers, dev), k=k,
                               min_ani=min_ani)
    return hist, st


def profile_step(bases, lengths, idx_key, gids, n_kmers, *, c: int, k: int,
                 n_genomes: int, n_buckets: int = DEFAULT_BUCKETS,
                 min_ani: float = 0.95,
                 device="cuda") -> Tuple[torch.Tensor, GenomeStats]:
    """One read batch -> (hist, stats): sketch_batch then finish_profile."""
    keys, _n = sketch_batch(bases, lengths, c=c, k=k, device=device)
    return finish_profile(keys, idx_key, gids, n_kmers, k=k,
                          n_genomes=n_genomes, n_buckets=n_buckets,
                          min_ani=min_ani, device=device)


def finish_profile_batched(smp_keys, idx_key, gids, n_kmers, *, k: int,
                           n_genomes: int, n_buckets: int = DEFAULT_BUCKETS,
                           min_ani: float = 0.95, device="cuda"):
    """Several samples at once: [S, ...] sample survivors -> (hist
    [S, G, H] int32, GenomeStats with [S, G] fields). One merge join per
    sample against the shared index (the JAX package vmaps it)."""
    dev = resolve_device(device)
    smp = _tensor(smp_keys, dev)
    idx, g = _tensor(idx_key, dev), _tensor(gids, dev)
    hist = torch.stack([
        merge_join_hist(idx, g, row, n_genomes=n_genomes,
                        n_buckets=n_buckets)
        for row in smp.reshape(smp.shape[0], -1)])
    st = stats_from_histograms(hist, _tensor(n_kmers, dev), k=k,
                               min_ani=min_ani)
    return hist, st


# ---- several devices: the (dp, ip) sharded step ---------------------------

def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              device="cuda"):
    """A ('dp', 'ip') ``DeviceMesh`` over the current process group, one
    rank a device (sylph_tpu/tpu/pipeline.py:283-305): dp = 2 when the
    rank count is even, else 1, ip = ranks / dp. On "cuda" each rank takes
    cuda:(rank % visible GPUs) unless ``device`` names one. Raises without
    a group, where ``n_devices`` differs from the group's size, or where
    dp does not divide it: the JAX package's fallback to CPU devices has
    no counterpart."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group, one rank a "
                           "device (utils/distributed.py::init_group)")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"need {n_devices} ranks, the group has {world}")
    dev = resolve_device(device)
    if dp is None:
        dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    ip = n_devices // dp
    if dp * ip != n_devices:
        raise ValueError(f"cannot factor {n_devices} devices into dp={dp} "
                         f"x ip={ip}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (dp, ip), mesh_dim_names=("dp", "ip"))


def _rank_device(mesh) -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if mesh.device_type == "cuda" else torch.device("cpu"))


def _gather_dp(keys: torch.Tensor, group) -> torch.Tensor:
    """Every dp rank's flat key stream of equal length, concatenated in dp
    order (``all_gather(..., 'dp', tiled=True)``). The lengths are
    gathered first: unequal ones raise, where the collective would fail."""
    n = dist.get_world_size(group)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts)
    size = torch.tensor([keys.numel()], dtype=torch.int64, device=keys.device)
    sizes = host_collective(gather, size, group).tolist()
    if len(set(sizes)) != 1:
        raise RuntimeError(f"dp ranks hold key streams of unequal lengths "
                           f"{sizes}")
    return host_collective(gather, keys, group)


def make_sharded_profile_step(mesh, *, c: int, k: int, n_genomes: int,
                              n_buckets: int = DEFAULT_BUCKETS,
                              min_ani: float = 0.95):
    """The one-shot profile step over ``mesh`` (sylph_tpu/tpu/pipeline.py:
    308-352): fn(bases, lengths, idx_key, gids, n_kmers) -> (hist [G, H]
    int32, GenomeStats), both the same on every rank.

    Every rank is handed the whole batch and index (numpy or tensors) and
    takes its share: the reads split over 'dp' (rank (d, i) takes the d-th
    of dp equal row blocks), the index over the whole grid (the (d*ip +
    i)-th of dp*ip equal blocks). Per rank, in order: the seeding
    (``_sketch_compact``: B6, or B9 under SYLPH_SEED_T=1, flattened read by
    read), ``condense_stream`` (B8), an all_gather of the key streams over
    'dp', the merge join of the gathered sample against the rank's index
    shard, an all_reduce (sum) of the int64 histograms over the grid, and
    the statistics. The batch's rows and the index's slots must divide
    evenly."""
    dp, ip = mesh.mesh.shape
    di, ii = mesh.get_coordinate()
    dp_group = mesh.get_group("dp")
    dev = _rank_device(mesh)

    def fn(bases, lengths, idx_key, gids, n_kmers):
        N, L = bases.shape
        M = idx_key.shape[0]
        if N % dp or M % (dp * ip):
            raise ValueError(f"{N} reads and {M} index slots must split "
                             f"evenly over dp={dp} and {dp * ip} ranks")
        n, m = N // dp, M // (dp * ip)
        b = _tensor(bases[di * n:(di + 1) * n], dev).to(dev)
        lens = _tensor(lengths[di * n:(di + 1) * n], dev).to(dev)
        keys = _sketch_compact(b, lens, c=c, k=k)
        # B9 keeps a read per column: flatten read by read (ROADMAP C)
        flat = (keys.t().reshape(-1) if _seed_route(n, L, c, k) == "B9"
                else keys.reshape(-1))
        live = (n * (L - k + 1) / c) / max(flat.numel(), 1)
        smp = _gather_dp(condense_stream(flat, live), dp_group)
        s0 = (di * ip + ii) * m
        hist = merge_join_hist(_tensor(idx_key[s0:s0 + m], dev).to(dev),
                               _tensor(gids[s0:s0 + m], dev).to(dev), smp,
                               n_genomes=n_genomes, n_buckets=n_buckets)

        def reduce(t):
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            return t
        hist = host_collective(reduce, hist.to(torch.int64)).to(torch.int32)
        st = stats_from_histograms(hist, _tensor(n_kmers, dev).to(dev),
                                   k=k, min_ani=min_ani)
        return hist, st
    return fn
