"""The plain reference on small cases worked by hand, and its vectorized
seeding against a scalar loop of sylph's algorithm."""

import math

import numpy as np
import torch

from perfbench.gen import hashing
from perfbench.reference import join, sketch, stats

M64 = (1 << 64) - 1


def _mm_hash_scalar(key: int) -> int:
    """sylph src/seeding.rs:4-15 on Python ints, mod 2^64."""
    key = ~(key + (key << 21)) & M64
    key ^= key >> 24
    key = (key + (key << 3) + (key << 8)) & M64
    key ^= key >> 14
    key = (key + (key << 2) + (key << 4)) & M64
    key ^= key >> 28
    return (key + (key << 31)) & M64


def _seeds_scalar(seq: str, c: int, k: int):
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    out = []
    for i in range(len(seq) - k + 1):
        w = seq[i:i + k]
        f = r = 0
        for j, b in enumerate(w):
            f = (f << 2) | code[b]
            r |= (3 - code[b]) << (2 * j)
        h = _mm_hash_scalar(min(f, r))
        if h < M64 // c:
            out.append(h)
    return sorted(out)


def _pack(seqs, row_len):
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    words = np.zeros((len(seqs), row_len // 16), np.uint64)
    for n, s in enumerate(seqs):
        for i, b in enumerate(s):
            words[n, i // 16] |= np.uint64(code[b] << (2 * (i % 16)))
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def test_seeding_matches_a_scalar_loop():
    rng = np.random.default_rng(4)
    seqs = ["".join(rng.choice(list("ACGT"), n)) for n in (150, 128, 31, 40)]
    packed = _pack(seqs, 256)
    lengths = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    got = sketch.batch_hashes(packed, lengths, c=3, k=31)
    want = sorted(h for s in seqs for h in _seeds_scalar(s, 3, 31))
    assert sorted(int(x) & M64 for x in got) == want
    assert len(want) > 30


def test_mm_hash_matches_the_scalar_form():
    v = torch.tensor([0, 1, 12345, (1 << 62) - 1], dtype=torch.int64)
    assert [int(x) & M64 for x in hashing.mm_hash64(v)] == [
        _mm_hash_scalar(int(x)) for x in v]


def test_multiset_counts_and_drops_pads():
    k, c = sketch.multiset(torch.tensor([5, -1, 7, 5, 5, -1, 2]))
    assert k.tolist() == [2, 5, 7] and c.tolist() == [1, 3, 1]


class _Index:
    G = 2

    def flat_blocks(self):
        yield 0, torch.tensor([10, 20, 30]), torch.tensor([0, 0, 1])
        yield 1, torch.tensor([20]), torch.tensor([1])


def test_join_by_hand():
    sk = (torch.tensor([20, 30, 40]), torch.tensor([2, 1, 5]))
    hist, n_kmers, matched = join.histograms(_Index(), [sk], 4)
    assert hist[0].tolist() == [[0, 0, 1, 0], [0, 1, 1, 0]]
    assert n_kmers.tolist() == [2, 2]
    assert matched.tolist() == [[2, 1]]


def test_statistics_by_hand():
    H = 64
    hist = torch.zeros((3, H), dtype=torch.int64)
    hist[0, 1], hist[0, 2], hist[0, 3] = 3, 2, 1          # covs 1,1,1,2,2,3
    hist[1, 1], hist[1, 2], hist[1, 3] = 60, 30, 10
    hist[2, 1], hist[2, 2], hist[2, 40] = 50, 10, 1        # 40: an outlier
    n = torch.tensor([100, 1000, 500])
    st = {f: v.tolist() for f, v in stats.genome_stats(hist, n, k=31).items()}
    k = 1 / 31
    assert st["contained"] == [6, 100, 61]
    assert st["median_cov"] == [2.0, 1.0, 1.0]
    assert st["n_inliers"] == [6, 100, 60]
    assert st["lam_valid"] == [0, 1, 1]
    assert math.isclose(st["naive_ani"][0], 0.06 ** k, rel_tol=1e-15)
    assert math.isclose(st["final_ani"][0], 0.06 ** k, rel_tol=1e-15)
    assert math.isclose(st["final_cov"][0], 10 / 6, rel_tol=1e-15)
    assert math.isclose(st["mean_cov"][0], 10 / 6, rel_tol=1e-15)
    assert math.isclose(st["final_cov"][1], 30 / 60 * 2, rel_tol=1e-15)
    adj = (100 / (1 - math.exp(-1.0)) / 1000) ** k
    assert math.isclose(st["final_ani"][1], adj, rel_tol=1e-15)
    assert math.isclose(st["final_cov"][2], 10 / 50 * 2, rel_tol=1e-15)
    assert math.isclose(st["mean_cov"][2], 70 / 61, rel_tol=1e-15)
    adj = (60 / (1 - math.exp(-0.4)) / (500 - 61 + 60)) ** k
    assert math.isclose(st["final_ani"][2], adj, rel_tol=1e-15)


def test_lower_precision_differs():
    hist = torch.zeros((1, 64), dtype=torch.int64)
    hist[0, 1], hist[0, 2], hist[0, 3] = 601, 307, 97
    n = torch.tensor([12288])
    hi = stats.genome_stats(hist, n, k=31)
    lo = stats.genome_stats(hist, n, k=31, dtype=torch.bfloat16)
    assert abs(float(hi["naive_ani"][0]) - float(lo["naive_ani"][0])) > 1e-4
