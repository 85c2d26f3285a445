"""64-bit invertible k-mer hash and 2-bit DNA encoding.

The hash is Thomas Wang's 64-bit mix *with the reference's deliberate bug
preserved*: the first step computes ``~(key + (key << 21))`` instead of
Wang's ``(~key) + (key << 21)`` (sylph src/seeding.rs:4-15, kept "for release
stability"). Every downstream number depends on this, so bit-exactness here
is load-bearing.

A trimmed copy of the JAX package's kmer/hashing.py: the numpy hash and its
inverse (used to plant chosen hashes into generated reads). The device
version is the B7 seeding kernel (csrc/seed.cu, gpu/seeding.py).
"""

import numpy as np

# 2-bit encoding: A/a=0, C/c=1, G/g=2, T/t/U/u=3; every other byte maps to 0
# (i.e. ambiguous bases silently become 'A') — matches sylph
# src/types.rs:50-59 including the quirk that bytes 0x00-0x03 map to 0..3.
BYTE_TO_SEQ_NP = np.zeros(256, dtype=np.uint8)
BYTE_TO_SEQ_NP[1] = 1
BYTE_TO_SEQ_NP[2] = 2
BYTE_TO_SEQ_NP[3] = 3
for _b, _v in [(ord("C"), 1), (ord("G"), 2), (ord("T"), 3), (ord("U"), 3)]:
    BYTE_TO_SEQ_NP[_b] = _v
    BYTE_TO_SEQ_NP[_b + 32] = _v  # lowercase


def mm_hash64_np(key: np.ndarray) -> np.ndarray:
    """Vectorized (bugged) Wang hash over a uint64 array (in-place friendly:
    allocates two buffers regardless of input size)."""
    u = np.uint64
    key = key.astype(np.uint64, copy=True)
    t = key << u(21)
    t += key
    np.invert(t, out=key)           # key = ~(key + (key << 21))
    np.right_shift(key, u(24), out=t)
    key ^= t
    np.left_shift(key, u(3), out=t)
    t += key
    key <<= u(8)
    key += t                         # key = key*265 (= k + k<<3 + k<<8)
    np.right_shift(key, u(14), out=t)
    key ^= t
    np.left_shift(key, u(2), out=t)
    t += key
    key <<= u(4)
    key += t                         # key = key*21 (= k + k<<2 + k<<4)
    np.right_shift(key, u(28), out=t)
    key ^= t
    np.left_shift(key, u(31), out=t)
    key += t
    return key


def inv_mm_hash64_np(hashed: np.ndarray) -> np.ndarray:
    """Vectorized inverse of the BUGGED ``mm_hash64`` (the seeding hash).

    The reference's ``rev_hash_64`` inverts the original Wang mix, so it
    does NOT invert its own seeding hash (sylph src/seeding.rs:5-52, bug
    documented there). This inverse is ours: it lets tests and synthetic
    workloads construct k-mers whose SKETCH HASH is a chosen value (e.g.
    planting index hits into generated reads). Shift-XOR steps invert by
    repeated back-substitution; multiply steps by modular inverse mod 2^64.
    """
    u = np.uint64
    key = hashed.astype(np.uint64, copy=True)
    # invert key += key << 31  (key *= 1 + 2^31)
    key *= u(4611686016279904257)
    # invert key ^= key >> 28 (two back-substitution rounds)
    t = key ^ (key >> u(28))
    key = key ^ (t >> u(28))
    # invert key *= 21
    key *= u(14933078535860113213)
    # invert key ^= key >> 14 (needs ceil(64/14)-1 = 4 rounds)
    t = key ^ (key >> u(14))
    t = key ^ (t >> u(14))
    t = key ^ (t >> u(14))
    key = key ^ (t >> u(14))
    # invert key *= 265
    key *= u(15244667743933553977)
    # invert key ^= key >> 24
    t = key ^ (key >> u(24))
    key = key ^ (t >> u(24))
    # invert key = ~(key + (key << 21)): undo NOT, then *= inv(1 + 2^21)
    key = ~key
    key *= u(9223376434899189761)
    return key
