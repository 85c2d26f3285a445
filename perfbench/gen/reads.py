"""The sample stream: a pool of distinct read samples made on the device
from the seed, each in the packed wire format ([batches, reads, row/16]
int32 words holding the uint32 bits of 16 2-bit bases, first base lowest;
docs/FORMATS.md), and left resident there.

The plant model (after sylph_tpu_torch/bench.py's ``_plant_pool`` and
``_make_overlay``, at the FracMinHash rate). A sample holds
``present_genomes`` genomes drawn from the index's plantable ones (every
key of which inverts to a canonical 31-mer, ``hashing.inv_mm_hash64``),
each at a read coverage taken in turn from the traffic's ``coverage``
levels, so every seed has the same coverages in another order. A genome
of n index k-mers stands for n*c bases: at coverage x it sends
ceil(x*n*c/read_len) reads, and each of its k-mers is held
Poisson(x*(read_len-k+1)/read_len) times, so a read of it carries about
(read_len-k+1)/c of its k-mers, as FracMinHash keeps them. A read has
read_len // k slots, each of which holds at most one planted 31-mer at a
random offset inside it; a genome's k-mer copies take distinct slots of
its reads at random. Around the plants, a present genome's read is a
filler row: random bases none of whose own windows is kept, so that its
kept k-mers are its plants, but for the windows that straddle a plant's
edge. The remaining reads are background: random bases, whose windows
are kept at the rate 1/c and match no index k-mer but by chance. Reads
are placed in the sample at random; the bases past ``read_len`` in a row
are 0, as the wire format pads them.
"""

from dataclasses import dataclass

import torch

from ..reference.sketch import window_hashes
from .hashing import inv_mm_hash64, lsr, usable

K = 31


@dataclass
class Pool:
    packed: torch.Tensor      # [samples, batches, reads, row_len/16] int32
    lengths: torch.Tensor     # [reads] int32, every read read_len long
    read_len: int

    @property
    def samples(self) -> int:
        return self.packed.shape[0]

    @property
    def bases(self) -> int:
        """Read bases a sample (the real ones, not the row padding)."""
        return self.packed.shape[1] * self.packed.shape[2] * self.read_len


@dataclass
class Plantable:
    keys: torch.Tensor        # the plantable genomes' keys, by genome id
    start: torch.Tensor       # [plantable] a genome's first key
    count: torch.Tensor       # [plantable] a genome's keys


def plantable(index) -> Plantable:
    """The keys of the index's genomes [0, index.plantable), grouped by
    genome."""
    ks, gs = [], []
    for _chunk, keys, gids in index.flat_blocks():
        mine = gids < index.plantable
        ks.append(keys[mine])
        gs.append(gids[mine].to(torch.int64))
    gids, order = torch.sort(torch.cat(gs), stable=True)
    keys = torch.cat(ks)[order]
    if not bool(usable(keys).all()):
        raise ValueError("a plantable genome holds a key no read can carry")
    count = torch.bincount(gids, minlength=index.plantable)
    return Plantable(keys, torch.cumsum(count, 0) - count, count)


def _random_rows(n: int, traffic: dict, gen) -> torch.Tensor:
    """[n, row_len/16] int64 words of read_len random bases, 0 past it."""
    L, W = traffic["read_len"], traffic["row_len"] // 16
    dev = gen.device
    words = torch.randint(0, 1 << 32, (n, W), dtype=torch.int64,
                          generator=gen, device=dev)
    nb = torch.clamp(L - 16 * torch.arange(W, device=dev), 0, 16)
    return words & ((torch.ones_like(nb) << (2 * nb)) - 1)


def _wire(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def filler_rows(traffic: dict, c: int, gen) -> torch.Tensor:
    """Random rows (int64 words) none of whose windows is kept at c."""
    n = traffic["filler_rows"]
    words = _random_rows(n, traffic, gen)
    lengths = torch.full((n,), traffic["read_len"], dtype=torch.int32,
                         device=words.device)
    _h, keep = window_hashes(_wire(words), lengths, c=c, k=K)
    return words[~keep.any(1)]


def sample_plan(pl: Plantable, n_reads: int, traffic: dict, c: int, gen):
    """One sample's plants: (hashes [O], read [O], offset [O] of each
    planted copy; [n_reads] bool, the reads of a present genome)."""
    dev = pl.keys.device
    L = traffic["read_len"]
    slots = L // K
    width = L // slots
    chosen = torch.randperm(pl.count.numel(), generator=gen, device=dev)[
        :traffic["present_genomes"]]
    g = chosen.numel()
    levels = torch.tensor(traffic["coverage"], dtype=torch.float64,
                          device=dev)
    cov = levels[torch.arange(g, device=dev) % levels.numel()]
    n_g = pl.count[chosen]
    reads_g = torch.ceil(cov * n_g * c / L).to(torch.int64)
    n_present = int(reads_g.sum())
    if n_present > n_reads:
        raise ValueError(f"the present genomes send {n_present} reads, the "
                         f"sample has {n_reads}: lower the coverages")
    # each k-mer of a present genome, held Poisson(lambda) times
    total = int(n_g.sum())
    rank = torch.repeat_interleave(torch.arange(g, device=dev), n_g,
                                   output_size=total)
    first = torch.cumsum(n_g, 0) - n_g
    kidx = pl.start[chosen][rank] + torch.arange(total, device=dev) \
        - first[rank]
    lam = (cov * (L - K + 1) / L).to(torch.float32)[rank]
    copies = torch.poisson(lam, generator=gen).to(torch.int64)
    n_occ = int(copies.sum())
    occ_key = torch.repeat_interleave(pl.keys[kidx], copies,
                                      output_size=n_occ)
    occ_g = torch.repeat_interleave(rank, copies, output_size=n_occ)
    occ_n = torch.bincount(occ_g, minlength=g)
    if bool((occ_n > reads_g * slots).any()):
        raise ValueError("a genome's k-mer copies outnumber its reads' slots")
    # a genome's slots in random order; its i-th copy takes the i-th
    slot_g = torch.repeat_interleave(torch.arange(g, device=dev),
                                     reads_g * slots,
                                     output_size=n_present * slots)
    perm = torch.randperm(n_present * slots, generator=gen, device=dev)
    shuffled = perm[torch.sort(slot_g[perm], stable=True).indices]
    slot_start = slots * (torch.cumsum(reads_g, 0) - reads_g)
    pos = torch.arange(n_occ, device=dev) - (torch.cumsum(occ_n, 0)
                                             - occ_n)[occ_g]
    slot = shuffled[slot_start[occ_g] + pos]
    off = (slot % slots) * width + torch.randint(
        0, width - K + 1, (n_occ,), generator=gen, device=dev)
    place = torch.randperm(n_reads, generator=gen, device=dev)
    present = torch.zeros(n_reads, dtype=torch.bool, device=dev)
    present[place[:n_present]] = True
    return occ_key, place[slot // slots], off, present


def reads_with(plants: torch.Tensor, row: torch.Tensor, off: torch.Tensor,
               present: torch.Tensor, filler: torch.Tensor, traffic: dict,
               gen) -> torch.Tensor:
    """[n, row_len/16] int32 packed reads: random bases, a filler row where
    ``present``, and each plant's 31-mer written at (row, off)."""
    words = _random_rows(present.numel(), traffic, gen)
    pr = present.nonzero().squeeze(1)
    words[pr] = filler[torch.randint(0, filler.shape[0], (pr.numel(),),
                                     generator=gen, device=gen.device)]
    vmer = inv_mm_hash64(plants)
    for j in range(K):
        p = off + j
        w, sh = p // 16, 2 * (p % 16)
        base = lsr(vmer, 2 * (K - 1 - j)) & 3
        # two plants of one read lie 31 bases apart or more: never in one
        # word at the same j
        words[row, w] = (words[row, w] & ~(3 << sh)) | (base << sh)
    return _wire(words)


def make_pool(index, traffic: dict, seed: int, device) -> Pool:
    """The traffic's pool of distinct samples, from ``seed``."""
    R, nb = traffic["reads_per_batch"], traffic["batches"]
    if traffic["row_len"] % 128 or traffic["read_len"] > traffic["row_len"]:
        raise ValueError("rows must be a multiple of 128 bases that holds "
                         "a read")
    pl = plantable(index)
    stream = (seed % (1 << 43)) << 20

    def gen(i):
        return torch.Generator(device=device).manual_seed(stream | i)
    filler = filler_rows(traffic, index.c, gen(1 << 19))
    packed = torch.empty((traffic["pool_samples"], nb, R,
                          traffic["row_len"] // 16), dtype=torch.int32,
                         device=device)
    for s in range(traffic["pool_samples"]):
        g = gen(s)
        plan = sample_plan(pl, nb * R, traffic, index.c, g)
        packed[s] = reads_with(*plan, filler, traffic, g).view(nb, R, -1)
    lengths = torch.full((R,), traffic["read_len"], dtype=torch.int32,
                         device=device)
    return Pool(packed, lengths, traffic["read_len"])
