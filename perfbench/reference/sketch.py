"""The plain reference of read sketching: FracMinHash over every k-mer
window of every read (sylph src/seeding.rs:86-146), in plain torch.

For each window of k bases inside its read: the forward k-mer (first base
highest, 2 bits a base), its reverse complement, the smaller of the two,
its sylph hash, kept iff the hash is below u64::MAX / c. A sample's sketch
is its kept hashes with their multiplicities, as the one-shot pipeline
counts them (every window of every read, no read deduplication).
"""

import torch

from ..gen.hashing import INT64_MIN, mm_hash64, threshold, u64_lt


def unpack(packed: torch.Tensor, length: int) -> torch.Tensor:
    """[N, W] int32 wire words -> [N, length] int64 2-bit codes (16 bases
    a word, first base in the lowest bits)."""
    w = packed.to(torch.int64) & 0xFFFFFFFF
    sh = 2 * torch.arange(16, device=packed.device, dtype=torch.int64)
    codes = (w[:, :, None] >> sh) & 3
    return codes.reshape(packed.shape[0], -1)[:, :length]


def window_hashes(packed: torch.Tensor, lengths: torch.Tensor, *, c: int,
                  k: int):
    """([N, W] int64 hashes of every k-mer window of a batch of reads,
    [N, W] bool: kept), W = the longest read's windows."""
    L = int(lengths.max())
    codes = unpack(packed, L)
    W = L - k + 1
    fwd = torch.zeros((codes.shape[0], W), dtype=torch.int64,
                      device=codes.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        x = codes[:, j:j + W]
        fwd = (fwd << 2) | x
        rev = rev | ((3 - x) << (2 * j))
    h = mm_hash64(torch.minimum(fwd, rev))
    pos = torch.arange(W, device=codes.device)
    keep = u64_lt(h, threshold(c)) & (pos[None, :] + k
                                      <= lengths.to(torch.int64)[:, None])
    return h, keep


def batch_hashes(packed: torch.Tensor, lengths: torch.Tensor, *, c: int,
                 k: int) -> torch.Tensor:
    """The kept hashes of one batch of reads, in no particular order."""
    h, keep = window_hashes(packed, lengths, c=c, k=k)
    return h[keep]


def multiset(hashes: torch.Tensor):
    """(distinct keys in uint64 order, counts int64) of a stream of int64
    hashes; -1 is a pad and is dropped."""
    live = hashes[hashes != -1]
    keys, counts = torch.unique_consecutive(
        torch.sort(live ^ INT64_MIN).values, return_counts=True)
    return keys ^ INT64_MIN, counts


def sketch_sample(packed: torch.Tensor, lengths: torch.Tensor, *, c: int,
                  k: int):
    """One sample's sketch from its [batches, N, W] wire words."""
    return multiset(torch.cat([batch_hashes(b, lengths, c=c, k=k)
                               for b in packed]))
