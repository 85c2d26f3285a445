"""ctypes bridge to native/sketchcore.c: the dedup fold, host seeding and
dedup fingerprints of read sketching, and the host seeding and spacing scan
of genome sketching.

A trimmed copy of the JAX package's core/native_core.py. The library is
built with ``cc`` at first use into build/native/ (utils/cbuild.py); the
port has no pure-Python fold, so a failed build raises.
"""

import ctypes
import os
from typing import Optional

import numpy as np

from ..utils import cbuild

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _bind(lib: ctypes.CDLL) -> None:
    lib.sk_free.argtypes = [ctypes.c_void_p]
    lib.sk_free.restype = None
    lib.sk_mean_fold.argtypes = [_I64P, ctypes.c_int64]
    lib.sk_mean_fold.restype = ctypes.c_double
    lib.sk_fold_new.argtypes = [ctypes.c_int, ctypes.c_uint32,
                                ctypes.c_double]
    lib.sk_fold_new.restype = ctypes.c_void_p
    lib.sk_fold_push.argtypes = [
        ctypes.c_void_p, _U64P, ctypes.c_int64, _I64P, ctypes.c_int64,
        _U64P, _U8P, _U8P]
    lib.sk_fold_push.restype = ctypes.c_int64
    lib.sk_fold_finish.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_U64P), ctypes.POINTER(_U32P),
        _I64P]
    lib.sk_fold_finish.restype = ctypes.c_int64
    lib.sk_fold_free.argtypes = [ctypes.c_void_p]
    lib.sk_fold_free.restype = None
    lib.sk_fold_reserve.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.sk_fold_reserve.restype = ctypes.c_int
    lib.sk_fold_order_count.argtypes = [ctypes.c_void_p]
    lib.sk_fold_order_count.restype = ctypes.c_int64
    lib.sk_fold_order_copy.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64, _U64P]
    lib.sk_fold_order_copy.restype = None
    lib.sk_fold_set_shard.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
    lib.sk_fold_set_shard.restype = ctypes.c_int
    lib.sk_fold_partition.argtypes = [
        _U64P, ctypes.c_int64, _I64P, ctypes.c_int64, ctypes.c_int,
        _U64P, _I64P, _I64P, _I64P]
    lib.sk_fold_partition.restype = None
    lib.sk_fold_push_seq.argtypes = [
        ctypes.c_void_p, _U64P, ctypes.c_int64, _I64P, ctypes.c_int64,
        _U64P, _U8P, _U8P, _I64P, ctypes.c_int64]
    lib.sk_fold_push_seq.restype = ctypes.c_int64
    lib.sk_fold_merge_order.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, _I64P, _I64P, _U64P]
    lib.sk_fold_merge_order.restype = ctypes.c_int64
    lib.sk_fold_merge_finish.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(_U64P), ctypes.POINTER(_U32P), _I64P]
    lib.sk_fold_merge_finish.restype = ctypes.c_int64
    lib.sx_seed_concat.argtypes = [
        _U8P, _I64P, _I64P, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(_I64P), ctypes.POINTER(_U64P)]
    lib.sx_seed_concat.restype = ctypes.c_int64
    lib.sx_seed_positions.argtypes = [
        _U8P, _I64P, _I64P, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(_I64P), ctypes.POINTER(_I64P),
        ctypes.POINTER(_U64P)]
    lib.sx_seed_positions.restype = ctypes.c_int64
    lib.sk_spacing_scan.argtypes = [
        _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, _U8P, _U8P]
    lib.sk_spacing_scan.restype = None
    lib.sx_fp_single.argtypes = [
        _U8P, _I64P, _I64P, _I64P, ctypes.c_int64, _U64P, _U8P]
    lib.sx_fp_single.restype = None
    lib.sx_fp_paired.argtypes = [
        _U8P, _I64P, _I64P, _U8P, _I64P, _I64P, _I64P, ctypes.c_int64,
        _U64P, _U8P]
    lib.sx_fp_paired.restype = None


def get_lib() -> ctypes.CDLL:
    return cbuild.load("sketchcore", ["-pthread"], _bind)


def _p(arr, typ):
    return arr.ctypes.data_as(typ)


def _take_u64_u32(lib, out_k, out_c, n: int):
    """Copy and free a (u64 keys, u32 counts) pair the C side malloc'd."""
    try:
        ks = np.ctypeslib.as_array(out_k, shape=(n,)).copy() if n \
            else np.empty(0, np.uint64)
        cs = np.ctypeslib.as_array(out_c, shape=(n,)).copy() if n \
            else np.empty(0, np.uint32)
    finally:
        lib.sk_free(out_k)
        lib.sk_free(out_c)
    return ks, cs


class StreamingFold:
    """Stateful native dedup fold: push (kmers, seg_starts, fps) chunks in
    read order, then finish() -> (kmers, counts, ndup) in first-insertion
    order."""

    def __init__(self, no_dedup: bool, threshold: Optional[int],
                 fpr: float = 0.0):
        self._lib = get_lib()
        thr = threshold if threshold is not None else (1 << 32) - 1
        self._st = self._lib.sk_fold_new(1 if no_dedup else 0,
                                         np.uint32(thr), float(fpr))
        if not self._st:
            raise MemoryError("sk_fold_new failure")
        self._order_seen = 0

    def new_keys(self) -> np.ndarray:
        """Keys inserted since the last call, in first-insertion order
        (the exact prefix order finish() will return). Lets the device
        ingest path stream the sample k-mers to the card while later
        blocks are still decoding."""
        n1 = int(self._lib.sk_fold_order_count(self._st))
        n0 = self._order_seen
        self._order_seen = n1
        if n1 <= n0:
            return np.empty(0, np.uint64)
        out = np.empty(n1 - n0, np.uint64)
        self._lib.sk_fold_order_copy(self._st, n0, n1, _p(out, _U64P))
        return out

    def reserve(self, n_keys: int) -> None:
        """Presize the tables for ~n_keys distinct k-mers (estimate; the
        fold still grows past it if low)."""
        if n_keys > 0 and not self._lib.sk_fold_reserve(
                self._st, int(n_keys)):
            raise MemoryError("sk_fold_reserve failure")

    def push(self, kmers: np.ndarray, seg_starts: np.ndarray,
             fps: np.ndarray, fp_valid: np.ndarray,
             filter_prev: Optional[np.ndarray] = None) -> int:
        kmers = np.ascontiguousarray(kmers, np.uint64)
        seg_starts = np.ascontiguousarray(seg_starts, np.int64)
        fps = np.ascontiguousarray(fps, np.uint64)
        fp_valid = np.ascontiguousarray(fp_valid, np.uint8)
        fprev = (np.ascontiguousarray(filter_prev, np.uint8)
                 if filter_prev is not None else None)
        ndup = self._lib.sk_fold_push(
            self._st, _p(kmers, _U64P), len(kmers), _p(seg_starts, _I64P),
            len(seg_starts), _p(fps, _U64P), _p(fp_valid, _U8P),
            _p(fprev, _U8P) if fprev is not None else None)
        if ndup < 0:
            raise MemoryError("sk_fold_push allocation failure")
        return int(ndup)

    def finish(self):
        out_k = _U64P()
        out_c = _U32P()
        out_n = ctypes.c_int64()
        ndup = self._lib.sk_fold_finish(self._st, ctypes.byref(out_k),
                                        ctypes.byref(out_c),
                                        ctypes.byref(out_n))
        if ndup < 0:
            raise MemoryError("sk_fold_finish allocation failure")
        ks, cs = _take_u64_u32(self._lib, out_k, out_c, out_n.value)
        return ks, cs, int(ndup)

    def close(self):
        if self._st:
            self._lib.sk_fold_free(self._st)
            self._st = None


class ShardedStreamingFold:
    """Hash-sharded parallel dedup fold: W shard states each own the
    k-mers whose mix64 lands in their shard; one C partition pass per push,
    then each shard folds its slice on a pool thread (the C pass releases
    the GIL). Per-key decision sequences are bit-identical to the serial
    StreamingFold (exact pair set only: bloom mode shares filter bits
    across keys), and the global first-insertion order is rebuilt by
    merging the shards' order streams on their recorded occurrence
    seqnos."""

    def __init__(self, no_dedup: bool, threshold: Optional[int],
                 n_shards: int = 4):
        from concurrent.futures import ThreadPoolExecutor
        if not (2 <= n_shards <= 64 and n_shards & (n_shards - 1) == 0):
            raise ValueError(f"n_shards must be a power of two in 2..64, "
                             f"got {n_shards}")     # the C merge caps at 64
        self._lib = get_lib()
        thr = threshold if threshold is not None else (1 << 32) - 1
        self._sts = []
        for w in range(n_shards):
            st = self._lib.sk_fold_new(1 if no_dedup else 0,
                                       np.uint32(thr), 0.0)
            if not st or not self._lib.sk_fold_set_shard(st, w, n_shards):
                for s in self._sts:
                    self._lib.sk_fold_free(s)
                raise MemoryError("sk_fold_set_shard failure")
            self._sts.append(st)
        self._W = n_shards
        self._starr = (ctypes.c_void_p * n_shards)(*self._sts)
        self._pool = ThreadPoolExecutor(max_workers=n_shards)
        self._order_seen = [0] * n_shards

    def reserve(self, n_keys: int) -> None:
        per = int(n_keys // self._W * 1.15) + 16
        for st in self._sts:
            if not self._lib.sk_fold_reserve(st, per):
                raise MemoryError("sk_fold_reserve failure")

    def push(self, kmers: np.ndarray, seg_starts: np.ndarray,
             fps: np.ndarray, fp_valid: np.ndarray,
             filter_prev: Optional[np.ndarray] = None) -> int:
        kmers = np.ascontiguousarray(kmers, np.uint64)
        seg_starts = np.ascontiguousarray(seg_starts, np.int64)
        fps = np.ascontiguousarray(fps, np.uint64)
        fp_valid = np.ascontiguousarray(fp_valid, np.uint8)
        fprev = (np.ascontiguousarray(filter_prev, np.uint8)
                 if filter_prev is not None else None)
        n, S, W = len(kmers), len(seg_starts), self._W
        pk = np.empty(n, np.uint64)
        pseq = np.empty(n, np.int64)
        psegs = np.empty(W * S, np.int64)
        pbase = np.empty(W + 1, np.int64)
        self._lib.sk_fold_partition(
            _p(kmers, _U64P), n, _p(seg_starts, _I64P), S, W,
            _p(pk, _U64P), _p(pseq, _I64P), _p(psegs, _I64P),
            _p(pbase, _I64P))

        def one(w):
            lo, hi = int(pbase[w]), int(pbase[w + 1])
            kk = pk[lo:hi]
            sq = pseq[lo:hi]
            sg = psegs[w * S:(w + 1) * S]
            return self._lib.sk_fold_push_seq(
                self._sts[w], _p(kk, _U64P), hi - lo, _p(sg, _I64P), S,
                _p(fps, _U64P), _p(fp_valid, _U8P),
                _p(fprev, _U8P) if fprev is not None else None,
                _p(sq, _I64P), n)

        ndups = list(self._pool.map(one, range(W)))
        if any(d < 0 for d in ndups):
            raise MemoryError("sk_fold_push allocation failure")
        return int(sum(ndups))

    def new_keys(self) -> np.ndarray:
        """Keys inserted since the last call, in global first-insertion
        order (merged across shards by seqno)."""
        ends = np.array([int(self._lib.sk_fold_order_count(st))
                         for st in self._sts], np.int64)
        starts = np.array(self._order_seen, np.int64)
        total = int((ends - starts).sum())
        if total <= 0:
            return np.empty(0, np.uint64)
        out = np.empty(total, np.uint64)
        n = self._lib.sk_fold_merge_order(
            self._starr, self._W, _p(starts, _I64P), _p(ends, _I64P),
            _p(out, _U64P))
        if n != total:
            raise RuntimeError(f"sk_fold_merge_order gave {n} keys, "
                               f"expected {total}")
        self._order_seen = [int(e) for e in ends]
        return out

    def finish(self):
        out_k = _U64P()
        out_c = _U32P()
        out_n = ctypes.c_int64()
        ndup = self._lib.sk_fold_merge_finish(
            self._starr, self._W, ctypes.byref(out_k),
            ctypes.byref(out_c), ctypes.byref(out_n))
        if ndup < 0:
            raise MemoryError("sk_fold_merge_finish failure")
        ks, cs = _take_u64_u32(self._lib, out_k, out_c, out_n.value)
        return ks, cs, int(ndup)

    def close(self):
        self._pool.shutdown(wait=True)
        for st in self._sts:
            self._lib.sk_fold_free(st)
        self._sts = []


def make_streaming_fold(no_dedup: bool, threshold: Optional[int],
                        fpr: float = 0.0):
    """The serial fold, or its 4-shard parallel form where the pair filter
    is exact (fpr == 0: bloom shares bits across keys) and the host has at
    least 8 cores (with fewer, the ingest pipeline already saturates them
    and the partition + merge cost more than they save)."""
    if fpr > 0.0 or (os.cpu_count() or 1) < 8:
        return StreamingFold(no_dedup, threshold, fpr)
    return ShardedStreamingFold(no_dedup, threshold, n_shards=4)


def seed_concat_native(codes: np.ndarray, starts: np.ndarray,
                       ends: np.ndarray, c: int, k: int):
    """(read_ids, hashes) FracMinHash survivors in (read, position) order:
    the host C seeder."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    out_r = _I64P()
    out_h = _U64P()
    n = lib.sx_seed_concat(_p(codes, _U8P), _p(starts, _I64P),
                           _p(ends, _I64P), len(starts), np.uint64(c),
                           int(k), ctypes.byref(out_r), ctypes.byref(out_h))
    if n < 0:
        raise MemoryError("sx_seed_concat allocation failure")
    try:
        rids = np.ctypeslib.as_array(out_r, shape=(n,)).copy() if n \
            else np.empty(0, np.int64)
        hashes = np.ctypeslib.as_array(out_h, shape=(n,)).copy() if n \
            else np.empty(0, np.uint64)
    finally:
        lib.sk_free(out_r)
        lib.sk_free(out_h)
    return rids, hashes


def seed_positions_native(codes: np.ndarray, starts: np.ndarray,
                          ends: np.ndarray, c: int, k: int):
    """(contig_ids, end_positions, hashes) FracMinHash survivors of every
    record, in (record, position) order: the host C seeder of genomes."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    out_c = _I64P()
    out_p = _I64P()
    out_h = _U64P()
    n = lib.sx_seed_positions(_p(codes, _U8P), _p(starts, _I64P),
                              _p(ends, _I64P), len(starts), np.uint64(c),
                              int(k), ctypes.byref(out_c),
                              ctypes.byref(out_p), ctypes.byref(out_h))
    if n < 0:
        raise MemoryError("sx_seed_positions allocation failure")
    try:
        cids = np.ctypeslib.as_array(out_c, shape=(n,)).copy() if n \
            else np.empty(0, np.int64)
        pos = np.ctypeslib.as_array(out_p, shape=(n,)).copy() if n \
            else np.empty(0, np.int64)
        hashes = np.ctypeslib.as_array(out_h, shape=(n,)).copy() if n \
            else np.empty(0, np.uint64)
    finally:
        lib.sk_free(out_c)
        lib.sk_free(out_p)
        lib.sk_free(out_h)
    return cids, pos, hashes


def spacing_scan_native(contigs: np.ndarray, positions: np.ndarray,
                        min_spacing: int, per_contig: bool,
                        pseudotax: bool):
    """(kept, tracked) bool masks of the greedy genome spacing scan
    (sylph src/sketch.rs:602-614; per_contig: :510-531)."""
    lib = get_lib()
    contigs = np.ascontiguousarray(contigs, np.int64)
    positions = np.ascontiguousarray(positions, np.int64)
    n = len(positions)
    kept = np.zeros(n, np.uint8)
    tracked = np.zeros(n, np.uint8)
    lib.sk_spacing_scan(_p(contigs, _I64P), _p(positions, _I64P), n,
                        min_spacing, 1 if per_contig else 0,
                        1 if pseudotax else 0, _p(kept, _U8P),
                        _p(tracked, _U8P))
    return kept.astype(bool), tracked.astype(bool)


def fp_single_native(codes: np.ndarray, starts: np.ndarray,
                     lengths: np.ndarray, rids: np.ndarray):
    """([n, 4] u64 fps, [n] u8 valid) pair_kmer_single dedup fingerprints
    (sylph src/sketch.rs:624-656)."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    rids = np.ascontiguousarray(rids, np.int64)
    n = rids.size
    fps = np.zeros((max(n, 1), 4), np.uint64)
    valid = np.zeros(max(n, 1), np.uint8)
    if n:
        lib.sx_fp_single(_p(codes, _U8P), _p(starts, _I64P),
                         _p(lengths, _I64P), _p(rids, _I64P), n,
                         _p(fps, _U64P), _p(valid, _U8P))
    return fps, valid


def fp_paired_native(codes1, starts1, lengths1, codes2, starts2, lengths2,
                     rids: np.ndarray):
    """Paired-end fingerprints (pair_kmer, sylph src/sketch.rs:658-688)."""
    lib = get_lib()
    codes1 = np.ascontiguousarray(codes1, np.uint8)
    starts1 = np.ascontiguousarray(starts1, np.int64)
    lengths1 = np.ascontiguousarray(lengths1, np.int64)
    codes2 = np.ascontiguousarray(codes2, np.uint8)
    starts2 = np.ascontiguousarray(starts2, np.int64)
    lengths2 = np.ascontiguousarray(lengths2, np.int64)
    rids = np.ascontiguousarray(rids, np.int64)
    n = rids.size
    fps = np.zeros((max(n, 1), 4), np.uint64)
    valid = np.zeros(max(n, 1), np.uint8)
    if n:
        lib.sx_fp_paired(_p(codes1, _U8P), _p(starts1, _I64P),
                         _p(lengths1, _I64P), _p(codes2, _U8P),
                         _p(starts2, _I64P), _p(lengths2, _I64P),
                         _p(rids, _I64P), n, _p(fps, _U64P),
                         _p(valid, _U8P))
    return fps, valid


def mean_fold_native(lengths: np.ndarray) -> float:
    """Sequential running mean (f64 bit-exact with the reference's fold,
    src/sketch.rs:824-826, 941-943)."""
    lib = get_lib()
    lengths = np.ascontiguousarray(lengths, np.int64)
    return float(lib.sk_mean_fold(_p(lengths, _I64P), len(lengths)))
