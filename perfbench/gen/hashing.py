"""The k-mer hash of sylph and its inverse, on int64 bit patterns in plain
torch (frozen copies of sylph_tpu_torch/gpu/seeding.py::mm_hash64 and
gpu/synth_index.py::inv_mm_hash64, rc31 and usable).

sylph hashes a canonical 31-mer with Thomas Wang's 64-bit mix as written in
its src/seeding.rs:4-15, whose first step is ``~(key + (key << 21))`` (a bug
kept for release stability). A 64-bit value is held as the int64 with the
same bits: adds and multiplies wrap alike, and right shifts are made logical
by a mask.
"""

import torch

U64_MAX = (1 << 64) - 1
INT64_MIN = -(1 << 63)


def as_i64(u: int) -> int:
    """The int64 with the bits of a uint64 value."""
    return u - (1 << 64) if u >= (1 << 63) else u


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def threshold(c: int) -> int:
    """FracMinHash keeps a hash iff it is below u64::MAX / c."""
    return U64_MAX // c


def u64_lt(a: torch.Tensor, b: int) -> torch.Tensor:
    """a < b in uint64 order, a an int64 bit pattern, b a uint64 value."""
    return (a ^ INT64_MIN) < (as_i64(b) ^ INT64_MIN)


def mm_hash64(key: torch.Tensor) -> torch.Tensor:
    key = ~(key + (key << 21))
    key = key ^ lsr(key, 24)
    key = key + (key << 3) + (key << 8)          # key * 265
    key = key ^ lsr(key, 14)
    key = key + (key << 2) + (key << 4)          # key * 21
    key = key ^ lsr(key, 28)
    return key + (key << 31)


def inv_mm_hash64(h: torch.Tensor) -> torch.Tensor:
    """The inverse of mm_hash64: multiplies by the modular inverses and
    shift-xors undone by back-substitution."""
    key = h * as_i64(4611686016279904257)       # undo key += key << 31
    t = key ^ lsr(key, 28)
    key = key ^ lsr(t, 28)                       # undo key ^= key >> 28
    key = key * as_i64(14933078535860113213)    # undo key *= 21
    t = key ^ lsr(key, 14)
    t = key ^ lsr(t, 14)
    t = key ^ lsr(t, 14)
    key = key ^ lsr(t, 14)                       # undo key ^= key >> 14
    key = key * as_i64(15244667743933553977)    # undo key *= 265
    t = key ^ lsr(key, 24)
    key = key ^ lsr(t, 24)                       # undo key ^= key >> 24
    return (~key) * as_i64(9223376434899189761)  # undo ~(key + key << 21)


def rc31(v: torch.Tensor) -> torch.Tensor:
    """Reverse complements of 31-mers packed 2 bits a base, first base
    highest: complement the low 62 bits, reverse the 2-bit groups, shift
    down."""
    x = ~v & ((1 << 62) - 1)
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = (lsr(x, sh) & m) | ((x & m) << sh)
    x = lsr(x, 32) | (x << 32)
    return lsr(x, 2)


def usable(h: torch.Tensor) -> torch.Tensor:
    """True where a hash inverts to a canonical 31-mer (v < 2^62 and v <=
    its reverse complement), which a read can then carry."""
    v = inv_mm_hash64(h)
    return (v >= 0) & (v < 1 << 62) & (v <= rc31(v))
