"""FracMinHash seeding — vectorized canonical k-mer extraction.

Behavioral spec (sylph src/seeding.rs:86-209, scalar path): for every k-mer
window of a sequence, take the canonical form ``min(forward, revcomp)`` by
64-bit integer compare (forward wins ties), hash it with the bugged Wang mix,
and keep the *hash* iff ``hash < u64::MAX / c``. Ambiguous bases encode as
'A'. Note the reference's AVX2 path drops the trailing ``(len-k+1) % 4``
windows of each sequence; we implement the exact (scalar) semantics, which is
the canonical FracMinHash definition.

Instead of the reference's sequential rolling update (O(1) state per base),
we build all windows at once with a log-doubling composition:

    F_{a+b}[i] = F_a[i] << 2b | F_b[i+a]
    R_{a+b}[i] = R_a[i]       | R_b[i+a] << 2a

where F_m[i] / R_m[i] are the forward / reverse-complement m-mers starting at
position i. This makes extraction a handful of whole-array shift/or passes.
A copy of the JAX package's kmer/seeding.py (less the genome-position
variant); the port seeds reads longer than the device batches with it
(engine/device_sketch.py).
"""

import numpy as np

from .hashing import BYTE_TO_SEQ_NP, mm_hash64_np

_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def fmh_threshold(c: int) -> np.uint64:
    """FracMinHash keep-threshold ``u64::MAX / c`` (src/seeding.rs:108)."""
    return np.uint64((1 << 64) - 1) // np.uint64(c)


def _decompose_pow2(k: int):
    """k as a descending list of powers of two (e.g. 31 -> [16,8,4,2,1])."""
    parts = []
    p = 1
    while p * 2 <= k:
        p *= 2
    rem = k
    while rem:
        if rem >= p:
            parts.append(p)
            rem -= p
        p //= 2
    return parts


def _canonical_kmers_block(bases: np.ndarray, k: int) -> np.ndarray:
    """Canonical k-mers for all start positions of one 2-bit base block."""
    n = bases.shape[0]
    if n < k:
        return np.empty(0, np.uint64)
    u = np.uint64
    f = bases.astype(np.uint64)
    r = u(3) - f
    pf = {1: f}
    pr = {1: r}
    m = 1
    while m * 2 <= k:
        f, r = pf[m], pr[m]
        L = f.shape[0] - m
        if L <= 0:
            break
        t = f[:L].copy()
        t <<= u(2 * m)
        t |= f[m:]
        pf[2 * m] = t
        t = r[m:].copy()
        t <<= u(2 * m)
        t |= r[:L]
        pr[2 * m] = t
        m *= 2

    parts = _decompose_pow2(k)
    size = parts[0]
    accf = pf[size]
    accr = pr[size]
    for p in parts[1:]:
        out_len = n - size - p + 1
        accf = accf[:out_len]
        accf <<= u(2 * p)
        accf |= pf[p][size:size + out_len]
        t = pr[p][size:size + out_len].copy()
        t <<= u(2 * size)
        t |= accr[:out_len]
        accr = t
        size += p
    # canonical = fwd if fwd < rc else rc (src/seeding.rs:134-139)
    lt = accf < accr
    return np.where(lt, accf, accr)


_BLOCK = 1 << 20  # cache-friendly block length (bases)


def canonical_kmers_np(bases: np.ndarray, k: int) -> np.ndarray:
    """Canonical k-mers for all start positions of a 2-bit base array.

    bases: uint8/uint64 array of values in 0..3, length n.
    Returns uint64 array of length n-k+1 (empty if n < k).

    Long arrays are processed in overlapping blocks with a (k-1)-base halo —
    the same seam trick the reference's AVX2 lanes use (src/avx2_seeding.rs:
    37-41, without its trailing-window drop).
    """
    n = bases.shape[0]
    if n < k:
        return np.empty(0, np.uint64)
    if n <= _BLOCK + k - 1:
        return _canonical_kmers_block(bases, k)
    out = np.empty(n - k + 1, np.uint64)
    for s in range(0, n - k + 1, _BLOCK):
        e = min(s + _BLOCK, n - k + 1)
        out[s:e] = _canonical_kmers_block(bases[s:e + k - 1], k)
    return out


def _as_base_array(seq) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        arr = seq
    else:
        arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    return BYTE_TO_SEQ_NP[arr]


def fmh_seeds_np(seq, c: int, k: int) -> np.ndarray:
    """All surviving k-mer hashes of one sequence, in position order.

    Equivalent to sylph ``fmh_seeds`` (src/seeding.rs:86-146).
    """
    bases = _as_base_array(seq)
    canon = canonical_kmers_np(bases, k)
    if canon.size == 0:
        return canon
    h = mm_hash64_np(canon)
    return h[h < fmh_threshold(c)]


def fmh_seeds_concat_np(concat_bases: np.ndarray, starts: np.ndarray,
                        ends: np.ndarray, c: int, k: int):
    """Batched seeding over many reads packed into one base array.

    concat_bases: uint8 2-bit codes of all reads back to back.
    starts/ends: int64 per-read [start, end) offsets into concat_bases,
    ascending and non-overlapping.

    Returns (read_ids, hashes), ordered by (read, position) — the same order
    the reference produces by looping reads then bases. Windows crossing a
    read boundary are masked out.
    """
    canon = canonical_kmers_np(concat_bases, k)
    if canon.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.uint64)
    h = mm_hash64_np(canon)
    mask = h < fmh_threshold(c)
    pos = np.nonzero(mask)[0]
    hh = h[pos]
    rid = np.searchsorted(starts, pos, side="right") - 1
    valid = pos + k <= ends[rid]
    return rid[valid].astype(np.int64), hh[valid]
