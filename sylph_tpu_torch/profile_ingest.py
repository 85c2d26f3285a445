"""Phase profiler of the raw-read ingest on the device (counterpart of
scripts/profile_ingest.py).

    python -m sylph_tpu_torch.profile_ingest [--reads R] [--blocks 4]
        [--device cuda|cpu]

Runs the single-end sketch's phases over the first ``--blocks`` blocks of
a fastq(.gz) (default .bench_data/e2e/reads.fastq.gz, from python -m
sylph_tpu_torch.bench_fixtures e2e) and prints each phase's wall seconds:
decode and parse once (cold), then, on a warm second pass,
engine/device_sketch.py's read_survivor_arrays taken apart: the batch
build (``_build_batch``), the 16-base packing (``_pack16_rows``), the upload
(``_upload_batch``'s copies), the seeding (``_seed_packed``: B7, the per-read
compaction, B8), the fetch of the condensed streams and counts, the redo
of a batch whose condensed stream lost survivors (B7 and the compaction
again, fetched uncondensed, as read_survivor_arrays does; the batches
redone are counted), the reorder (the stable argsort by read), the dedup
fingerprints (``fp_single_native``) and the fold. Reads longer than the
largest bucket are seeded on the host (``long reads``). Each device phase
ends in one ``torch.cuda.synchronize()``, so a phase's time is its own.

Check, raising on failure: the folded (k-mers, counts) equal
``sketch_sequences`` of the same blocks with the host C seeder.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from .constants import MAX_DEDUP_COUNT
from .core.native_core import fp_single_native, make_streaming_fold
from .core.sketch_reads import sketch_sequences
from .engine import device_sketch as ds
from .gpu.grange import resolve_device
from .io.fastx import parse_block, stream_blocks
from .kmer.seeding import fmh_seeds_np

C, K = 200, 31
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = os.path.join(_ROOT, ".bench_data", "e2e", "reads.fastq.gz")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _seed_block(px, dev, tick, batches):
    """read_survivor_arrays of one parsed block, phase by phase: (read
    ids, hashes) in (read, position) order. ``batches`` counts the batches
    seeded and redone."""
    lengths = px.lengths
    pending = []
    short = np.flatnonzero((lengths >= K) & (lengths <= ds._BUCKETS[-1]))
    bucket_of = np.searchsorted(np.asarray(ds._BUCKETS), lengths[short],
                                side="left")
    for bi, b in enumerate(ds._BUCKETS):
        sel = short[bucket_of == bi]
        for s in range(0, sel.size, ds._MAX_BATCH):
            rids = sel[s:s + ds._MAX_BATCH]
            if rids.size == 0:
                continue
            t0 = time.perf_counter()
            bases, blens = ds._build_batch(px, b, rids)
            tick("build_batch", t0)
            t0 = time.perf_counter()
            packed = ds._pack16_rows(bases).view(np.int32)
            tick("pack16", t0)
            t0 = time.perf_counter()
            packed_d = torch.from_numpy(packed).to(dev)
            lens_d = torch.from_numpy(blens).to(dev)
            _sync(dev)
            tick("upload", t0)
            t0 = time.perf_counter()
            stream, n_r = ds._seed_packed(packed_d, lens_d, C, K, b)
            _sync(dev)
            tick("seed (B7, compaction, B8)", t0)
            pending.append((b, rids, packed_d, lens_d, stream, n_r))
            batches["seeded"] += 1
    parts_r, parts_h = [], []
    for b, rids, packed_d, lens_d, stream, n_r in pending:
        t0 = time.perf_counter()
        nr_h = n_r.cpu().numpy()[:rids.size].astype(np.int64)
        s = stream.cpu().numpy()
        live = s != -1
        tick("fetch+mask", t0)
        if int(live.sum()) != int(nr_h.sum()):
            t0 = time.perf_counter()
            rows = ds._seed_rows(packed_d, lens_d, C, K,
                                 b).cpu().numpy()[:rids.size]
            lv = rows != -1
            parts_r.append(np.broadcast_to(rids[:, None],
                                           rows.shape)[lv].astype(np.int64))
            parts_h.append(rows[lv].view(np.uint64))
            tick("redo (B7, compaction, fetch)", t0)
            batches["redone"] += 1
            continue
        parts_r.append(np.repeat(rids, nr_h))
        parts_h.append(s[live].view(np.uint64))
    t0 = time.perf_counter()
    for rid in np.flatnonzero(lengths > ds._BUCKETS[-1]).tolist():
        h = fmh_seeds_np(px.record_codes(rid), C, K)
        if h.size:
            parts_r.append(np.full(h.size, rid, np.int64))
            parts_h.append(h)
    tick("long reads (host)", t0)
    t0 = time.perf_counter()
    if not parts_h:
        return np.empty(0, np.int64), np.empty(0, np.uint64)
    rids_all = np.concatenate(parts_r)
    hashes_all = np.concatenate(parts_h)
    order = np.argsort(rids_all, kind="stable")
    tick("reorder", t0)
    return rids_all[order], hashes_all[order]


def run(reads: str = READS, n_blocks: int = 4, device="cuda") -> dict:
    """Phase seconds ({phase: s}), sizes and the check's result; raises
    if the folded sketch differs from sketch_sequences'."""
    dev = resolve_device(device)
    T = {}

    def tick(name, t0):
        T[name] = T.get(name, 0.0) + (time.perf_counter() - t0)

    blocks = []
    t0 = time.perf_counter()
    for i, b in enumerate(stream_blocks(reads)):
        blocks.append(bytes(b))
        if i + 1 >= n_blocks:
            break
    tick("decode", t0)
    t0 = time.perf_counter()
    pxs = [parse_block(b, reads, skip_names=True) for b in blocks]
    tick("parse", t0)
    nbases = sum(int(px.codes.size) for px in pxs)
    cold = dict(T)
    for rep in range(2):                 # rep 0 warms the kernels and pages
        T.clear()
        batches = {"seeded": 0, "redone": 0}
        fold = make_streaming_fold(False, MAX_DEDUP_COUNT)
        try:
            for px in pxs:
                rids, hashes = _seed_block(px, dev, tick, batches)
                if rids.size == 0:
                    continue
                t0 = time.perf_counter()
                seg_starts = np.concatenate(
                    [[0], np.flatnonzero(np.diff(rids)) + 1]).astype(np.int64)
                fps, valid = fp_single_native(px.codes, px.starts,
                                              px.lengths, rids[seg_starts])
                tick("fingerprints", t0)
                t0 = time.perf_counter()
                fold.push(hashes, seg_starts, fps, valid, None)
                tick("fold", t0)
            t0 = time.perf_counter()
            ks, cs, _ndup = fold.finish()
            tick("fold", t0)
        finally:
            fold.close()
    warm = dict(T)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "blocks.fq")
        with open(path, "wb") as f:
            for b in blocks:
                f.write(b)
        want = sketch_sequences(path, C, K, None, False, device=None)
    order = np.argsort(ks)
    wk, wc = want.sorted_view()
    same = (np.array_equal(ks[order], wk)
            and np.array_equal(cs[order].astype(np.int64),
                               np.asarray(wc, np.int64)))
    if not same:
        raise RuntimeError(f"profile_ingest: the phased sketch ({ks.size} "
                           f"k-mers) differs from sketch_sequences' "
                           f"({want.kmers.size})")
    gbp = nbases / 1e9
    tot = sum(warm.values())
    print(f"\n{n_blocks} blocks, {sum(map(len, blocks)) / 1e6:.0f} MB "
          f"text, {gbp:.3f} Gbp, {ks.size} distinct k-mers (warm pass):")
    for k, v in sorted(warm.items(), key=lambda x: -x[1]):
        rate = f"  ({gbp / v:.2f} Gbp/s)" if v > 0 else ""
        print(f"  {k:28s} {v:7.3f} s{rate}")
    print(f"  {'TOTAL (warm)':28s} {tot:7.3f} s  ({gbp / tot:.3f} Gbp/s)  "
          f"[+decode {cold['decode']:.1f} s +parse {cold['parse']:.1f} s "
          f"cold]; {batches['redone']} of {batches['seeded']} batches "
          "redone", flush=True)
    return dict(blocks=len(blocks), gbp=gbp, kmers=int(ks.size),
                cold=cold, warm=warm, total_warm_s=tot, batches=batches,
                equal=True)


def main(argv: Optional[list] = None) -> int:
    if argv is None:
        from .cli import _tune_allocator
        _tune_allocator("sylph_tpu_torch.profile_ingest")
    ap = argparse.ArgumentParser(
        prog="python -m sylph_tpu_torch.profile_ingest",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", default=READS)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        from .gpu._cuda import card_line
        print(card_line(), flush=True)
    if not os.path.exists(a.reads):
        raise SystemExit(f"{a.reads} not found (python -m "
                         "sylph_tpu_torch.bench_fixtures e2e makes it)")
    print("profile_ingest: " + json.dumps(run(a.reads, a.blocks, dev)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
