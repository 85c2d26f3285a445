"""The two kinds of genome index the drivers serve, as the benchmark makes
them, and the one view of them that the plants and the reference
read: (keys, genome ids) of every index k-mer, block by block.

  GrangeIndex   the grange generator's index (gen/grange_index.py): made
                on the device from slot counters, laid out for the port by
                ``chunk_layout``; the keys of its first
                ``plantable_genomes`` genomes all usable
  FlatIndex     G genomes of KPG uniform hashes below u64::MAX / c each,
                every one usable (drawn from a seed of the configuration,
                the others drawn again), keys sorted

``plantable`` is the number of genomes, ids [0, plantable), whose every
key inverts to a canonical 31-mer (hashing.usable): the genomes a sample
can hold.

Keys are int64 bit patterns of uint64 hashes (c >= 2 keeps them below
2^63); genome ids are int64 (grange) or int32 (flat) in the flat view.
"""

import torch

from . import grange_index
from .hashing import threshold, usable


class GrangeIndex:
    def __init__(self, spec: dict, device):
        self.G = spec["genomes"]
        self.c, self.k = spec["c"], spec["k"]
        self.geo = grange_index.geometry(
            self.G, spec["kmers_per_genome"], self.c, spec["chunk_slots"],
            spec["target_mean"], spec["nt"], spec["plantable_genomes"])
        self.plantable = self.geo.plantable
        self.device = device

    def flat_blocks(self):
        return grange_index.flat_blocks(self.geo, self.device)


class FlatIndex:
    BLOCK = 1 << 24

    def __init__(self, spec: dict, device):
        self.G = spec["genomes"]
        self.c, self.k = spec["c"], spec["k"]
        kpg = spec["kmers_per_genome"]
        gen = torch.Generator(device=device).manual_seed(spec["index_seed"])
        keys = _usable_uniform(self.G * kpg, threshold(self.c), gen, device,
                               self.BLOCK)
        self.keys, order = torch.sort(keys)
        del keys
        self.gids = torch.div(order, kpg, rounding_mode="floor").to(
            torch.int32)
        self.plantable = self.G
        self.device = device

    def flat_blocks(self):
        for i in range(0, self.keys.numel(), self.BLOCK):
            yield 0, self.keys[i:i + self.BLOCK], self.gids[i:i + self.BLOCK]


def _usable_uniform(n: int, top: int, gen, device, block: int):
    """[n] int64 hashes uniform below ``top`` that are usable: draws of at
    most ``block`` at a time, the unusable ones left out."""
    parts, have = [], 0
    while have < n:
        m = min(block, max(1 << 12, 10 * (n - have)))
        draw = torch.randint(0, top, (m,), generator=gen,
                             dtype=torch.int64, device=device)
        ok = draw[usable(draw)][:n - have]
        parts.append(ok)
        have += ok.numel()
    return torch.cat(parts)
