"""Read sketching: FracMinHash counting with PCR-duplicate removal
(counterpart of sylph_tpu/core/sketch_reads.py, streaming bodies only).

Behavioral spec:
  - single-end: sylph src/sketch.rs:897-959 (dedup fingerprints only for
    reads <= 400 bp, consulted only while a k-mer's count < MAX_DEDUP_COUNT)
  - paired-end: src/sketch.rs:771-895 (fingerprint from both mates; R2
    k-mers already seen in the same pair's R1 are skipped)
  - dedup cell: dup_removal_lsh_full_exact src/sketch.rs:690-731.

Paired-end dedup honors --fpr like the reference (src/sketch.rs:800-804):
fpr == 0 selects the exact pair set, fpr > 0 a memory-bounded scalable
blocked-bloom filter inside the native fold.

Seeding: with ``device=None`` the native C seeder runs on the host; given a
``torch.device`` the reads are seeded there (engine/device_sketch.py, the B7
kernel and the B8 repack on a CUDA device, their plain versions on the
CPU). The order-dependent dedup fold always runs in native C on the host,
so sketches are identical either way.
"""

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..constants import MAX_DEDUP_COUNT
from ..io.fastx import FastxParseError, check_readable
from .native_core import (fp_paired_native, fp_single_native,
                          make_streaming_fold, mean_fold_native,
                          seed_concat_native)
from .types import SequencesSketch

log = logging.getLogger("sylph")


def _ingest_workers() -> int:
    """Parse+seed worker threads for the streaming ingest: half the cores
    (2..12), capped by the CLI's -t budget (utils/threads)."""
    from ..utils.threads import cap_workers
    return cap_workers(max(2, min(12, (os.cpu_count() or 4) // 2)))


def _mean_fold(lengths: np.ndarray) -> float:
    """Sequential running mean, bit-exact with the reference's f64 fold
    (src/sketch.rs:824-826, 941-943)."""
    if lengths.size == 0:
        return 0.0
    if np.all(lengths == lengths[0]):
        return float(lengths[0])  # the fold is exact when all equal
    return mean_fold_native(lengths)


def _seeder(c: int, k: int, device: Optional[torch.device]):
    """px -> (read_ids, hashes) in (read, position) order."""
    if device is None:
        return lambda px: seed_concat_native(px.codes, px.starts, px.ends,
                                             c, k)
    from ..engine.device_sketch import read_survivor_arrays
    return lambda px: read_survivor_arrays(px, c, k, device)


def _sketch_single_streaming(read_file: str, c: int, k: int,
                             sample_name, no_dedup: bool,
                             device: Optional[torch.device],
                             on_segment=None):
    """Streaming single-end sketch, pipelined three ways: a producer thread
    decodes gzip blocks (zlib releases the GIL), a small worker pool parses
    + seeds + fingerprints each block concurrently, and the main thread
    folds results in file order (the dedup fold is order-dependent).
    Memory stays bounded at a few blocks regardless of sample size."""
    import queue
    import threading
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ..io.fastx import parse_block, stream_blocks
    from ..utils.timing import PhaseAcc

    seed = _seeder(c, k, device)
    acc = PhaseAcc() if log.isEnabledFor(logging.DEBUG) else None
    t_wall = time.perf_counter

    q: "queue.Queue" = queue.Queue(maxsize=3)
    err = []

    def producer():
        try:
            it = stream_blocks(read_file)
            while True:
                t0 = t_wall()
                block = next(it, None)
                if acc:
                    acc.add("decode", t_wall() - t0)
                if block is None:
                    break
                q.put(block)
        except Exception as e:      # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(None)

    def prepare(block: bytes):
        """block -> (lengths, hashes, seg_starts, fps, valid): parse +
        seed + fingerprint (runs in the pool)."""
        t0 = t_wall()
        px = parse_block(block, read_file, skip_names=True)
        if acc:
            acc.add("parse", t_wall() - t0)
            t0 = t_wall()
        rids, hashes = seed(px)
        if acc:
            acc.add("seed", t_wall() - t0)
            t0 = t_wall()
        if rids.size == 0:
            return px.lengths, hashes, None, None, None
        boundaries = np.flatnonzero(np.diff(rids)) + 1
        seg_starts = np.concatenate([[0], boundaries]).astype(np.int64)
        seg_rids = rids[seg_starts]
        if no_dedup:
            fps = np.zeros((seg_starts.size, 4), np.uint64)
            valid = np.zeros(seg_starts.size, np.uint8)
        else:
            fps, valid = fp_single_native(px.codes, px.starts, px.lengths,
                                          seg_rids)
        if acc:
            acc.add("fp", t_wall() - t0)
        return px.lengths, hashes, seg_starts, fps, valid

    t_start = t_wall()
    t = threading.Thread(target=producer, daemon=True)
    t.start()
    fold = make_streaming_fold(no_dedup, MAX_DEDUP_COUNT)
    lens_parts = []
    # fold-table presize: extrapolate the first block's survivor rate over
    # the whole file (compressed size x a typical fastq gzip ratio) so the
    # hash tables take one rehash instead of a doubling cascade
    fsize = os.path.getsize(read_file)
    est_total_text = fsize * (3.3 if read_file.endswith((".gz", ".bgz"))
                              else 1.0)
    reserved = False
    try:
        nw = _ingest_workers()
        with ThreadPoolExecutor(max_workers=nw) as pool:
            futs = deque()
            done = False
            while futs or not done:
                while not done and len(futs) < nw + 1:
                    block = q.get()
                    if block is None:
                        done = True
                        break
                    futs.append((pool.submit(prepare, block), len(block)))
                if not futs:
                    break
                fut, blen = futs.popleft()
                t0 = t_wall()
                lengths, hashes, seg_starts, fps, valid = fut.result()
                if acc:
                    acc.add("wait", t_wall() - t0)
                lens_parts.append(lengths)
                if seg_starts is None:
                    continue
                t0 = t_wall()
                if not reserved:
                    reserved = True
                    if est_total_text > blen:
                        fold.reserve(int(hashes.size * est_total_text
                                         / blen * 1.25))
                fold.push(hashes, seg_starts, fps, valid, None)
                if on_segment is not None:
                    on_segment(fold.new_keys())
                if acc:
                    acc.add("fold", t_wall() - t0)
        t.join()
        if err:
            raise err[0]
        if not lens_parts:
            raise FastxParseError(f"{read_file}: empty file")
        t0 = t_wall()
        ks, cs, ndup = fold.finish()
        if acc:
            acc.add("finish", t_wall() - t0)
            acc.log_summary(read_file, t_wall() - t_start)
    finally:
        fold.close()
    total = int(cs.sum()) + ndup
    if total:
        log.debug("Dedup removed %d sketched k-mers for %s (%.2f%%)",
                  ndup, read_file, 100.0 * ndup / total)
    mean_len = _mean_fold(np.concatenate(lens_parts))
    return SequencesSketch(kmers=ks, counts=cs, c=c, k=k,
                           file_name=read_file, sample_name=sample_name,
                           paired=False, mean_read_length=mean_len)


def sketch_sequences(read_file: str, c: int, k: int,
                     sample_name: Optional[str] = None,
                     no_dedup: bool = False,
                     device: Optional[torch.device] = None,
                     on_segment=None) -> Optional[SequencesSketch]:
    """Single-end read sketch (sylph src/sketch.rs:897-959).

    ``device`` None seeds with the native C seeder on the host; a torch
    device seeds there. ``on_segment(kmers_u64)``, if given, receives the
    newly-inserted distinct k-mers after each pushed block, in
    first-insertion order (their concatenation equals the returned
    sketch's ``kmers``): the device engine streams them to the card during
    the ingest."""
    try:
        check_readable(read_file)
        return _sketch_single_streaming(read_file, c, k, sample_name,
                                        no_dedup, device,
                                        on_segment=on_segment)
    except FastxParseError:
        log.warning("%s is not a valid fasta/fastq file; skipping.",
                    read_file)
        return None


def _paired_fold_arrays(px1, px2, rids1, h1, rids2, h2, no_dedup):
    """Interleave per-pair R1/R2 survivor segments into the flat arrays
    the fold consumes: (kmers, seg_starts, fps, valid, filter_prev).
    Segment order is rid-ascending with [R1, R2] per pair; R2 carries
    filter_prev (skip k-mers present in the same pair's R1), matching
    the reference's loop (src/sketch.rs:851-876)."""
    n = px1.n_records
    c1 = np.bincount(rids1, minlength=n).astype(np.int64)
    c2 = np.bincount(rids2, minlength=n).astype(np.int64)
    act = np.flatnonzero((c1 > 0) | (c2 > 0))
    if act.size == 0:
        return None
    inv = np.full(n, -1, np.int64)
    inv[act] = np.arange(act.size)
    s1 = c1[act]
    s2 = c2[act]
    t = s1 + s2
    base = np.concatenate([[0], np.cumsum(t)[:-1]])
    out = np.empty(int(t.sum()), np.uint64)
    if rids1.size:
        first1 = np.concatenate([[0], np.cumsum(c1)[:-1]])
        loc1 = np.arange(rids1.size) - first1[rids1]
        out[base[inv[rids1]] + loc1] = h1
    if rids2.size:
        first2 = np.concatenate([[0], np.cumsum(c2)[:-1]])
        loc2 = np.arange(rids2.size) - first2[rids2]
        a2 = inv[rids2]
        out[base[a2] + s1[a2] + loc2] = h2
    seg_starts = np.empty(2 * act.size, np.int64)
    seg_starts[0::2] = base
    seg_starts[1::2] = base + s1
    if no_dedup:
        fps2 = np.zeros((2 * act.size, 4), np.uint64)
        valid2 = np.zeros(2 * act.size, np.uint8)
    else:
        fps, valid = fp_paired_native(px1.codes, px1.starts, px1.lengths,
                                      px2.codes, px2.starts, px2.lengths,
                                      act)
        fps2 = np.repeat(fps, 2, axis=0)
        valid2 = np.repeat(valid, 2)
    fprev = np.zeros(2 * act.size, np.uint8)
    fprev[1::2] = 1
    return out, seg_starts, fps2, valid2, fprev


def _sketch_pair_streaming(read_file1: str, read_file2: str, c: int,
                           k: int, sample_name, no_dedup: bool,
                           fpr: float, device: Optional[torch.device],
                           on_segment=None):
    """Streaming paired-end sketch: both mate files decode and parse in
    record-aligned chunks (memory bounded), segments interleave vectorized,
    and the stateful C fold (exact set or bloom per fpr) runs in pair
    order."""
    import queue
    import threading
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ..io.fastx import stream_fastx_pairs

    seed = _seeder(c, k, device)
    q: "queue.Queue" = queue.Queue(maxsize=3)
    err = []

    def producer():                  # decode + parse both mates, in order
        try:
            for pair in stream_fastx_pairs(read_file1, read_file2):
                q.put(pair)
        except Exception as e:
            err.append(e)
        finally:
            q.put(None)

    def prepare(pair):               # seed + interleave
        px1, px2 = pair
        rids1, h1 = seed(px1)
        rids2, h2 = seed(px2)
        return px1.lengths, _paired_fold_arrays(px1, px2, rids1, h1,
                                                rids2, h2, no_dedup)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    fold = make_streaming_fold(no_dedup, None,
                               fpr=0.0 if no_dedup else fpr)
    lens1 = []
    try:
        nw = _ingest_workers()
        with ThreadPoolExecutor(max_workers=nw) as pool:
            futs = deque()
            done = False
            while futs or not done:
                while not done and len(futs) < nw + 1:
                    pair = q.get()
                    if pair is None:
                        done = True
                        break
                    futs.append(pool.submit(prepare, pair))
                if not futs:
                    break
                lengths, built = futs.popleft().result()
                lens1.append(lengths)
                if built is not None:
                    fold.push(*built)
                    if on_segment is not None:
                        on_segment(fold.new_keys())
        t.join()
        if err:
            raise err[0]
        ks, cs, ndup = fold.finish()
    finally:
        fold.close()
    total = int(cs.sum()) + ndup
    if total:
        log.debug(
            "Number of sketched k-mers removed due to read duplication for "
            "%s: %d. Percentage: %.2f%%", read_file1, ndup,
            100.0 * ndup / total)
    mean_len = _mean_fold(np.concatenate(lens1) if lens1
                          else np.empty(0, np.int64))
    return SequencesSketch(kmers=ks, counts=cs, c=c, k=k,
                           file_name=read_file1, sample_name=sample_name,
                           paired=True, mean_read_length=mean_len)


def sketch_pair_sequences(read_file1: str, read_file2: str, c: int, k: int,
                          sample_name: Optional[str] = None,
                          no_dedup: bool = False,
                          fpr: float = 0.0,
                          device: Optional[torch.device] = None,
                          on_segment=None) -> Optional[SequencesSketch]:
    """Paired-end read sketch (sylph src/sketch.rs:771-895).

    ``fpr == 0`` dedups with an exact pair set; ``fpr > 0`` (the CLI
    default, 1e-4) with the memory-bounded scalable bloom filter (the
    reference's ScalableCuckooFilter role)."""
    try:
        check_readable(read_file1, read_file2)
        return _sketch_pair_streaming(read_file1, read_file2, c, k,
                                      sample_name, no_dedup, fpr, device,
                                      on_segment=on_segment)
    except FastxParseError:
        log.error("Paired end reading failed for '%s' and '%s'.",
                  read_file1, read_file2)
        raise SystemExit(1)
