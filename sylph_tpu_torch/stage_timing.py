"""Per-stage timings of device seeding and compaction (counterpart of
scripts/stage_timing.py).

    python -m sylph_tpu_torch.stage_timing [--reps 5] [--device cuda|cpu]

On one [65,536, 256] batch of random 2-bit codes (c=200, k=31, numpy seed
0), each stage timed over ``--reps`` runs after a first run that pays the
kernel build, a synchronize closing each run:

  1. plain PyTorch seeding (gpu/seeding.py::seed_hashes, the log-doubling
     canonical k-mers and the hash in torch ops);
  2. the B7 kernel (seed_packed on the codes packed into words);
  3. the compaction of B7's survivors into sorted rows of 512 windows at
     capacity 4*512/c + 8 (gpu/containment.py::compact_rows, the one-shot
     pipeline's fallback).

Checks, raising on failure: both seedings keep the same survivors (count
and hashes), and the compaction keeps every one of them.
"""

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from .gpu.containment import compact_rows
from .gpu.grange import resolve_device
from .gpu.keys import KEY_PAD
from .gpu.pipeline import _pack_words, compaction_cap
from .gpu.seeding import seed_hashes, seed_packed

N, L, C, K = 65536, 256, 200, 31


def _log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def run(device="cuda", reps: int = 5, n: int = N) -> dict:
    """{stage: {first_s, ms, gbps}} and the survivor counts; raises where
    the stages disagree."""
    dev = resolve_device(device)
    mbp = n * L / 1e6
    rng = np.random.default_rng(0)
    bases = torch.from_numpy(rng.integers(0, 4, size=(n, L),
                                          dtype=np.uint8)).to(dev)
    lengths = torch.full((n,), L, dtype=torch.int32, device=dev)
    W = L - K + 1
    _log(f"data on {dev} ({n}x{L} = {mbp:.1f} Mbp)")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        res = fn()
        sync()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn()
        sync()
        dt = (time.perf_counter() - t0) / reps
        out[name] = dict(first_s=first, ms=dt * 1e3, gbps=mbp / 1e3 / dt)
        _log(f"{name}: first run {first:.2f} s, {dt * 1e3:.2f} ms -> "
             f"{mbp / 1e3 / dt:.2f} Gbp/s")
        return res

    h_plain, k_plain = stage("plain seed", lambda: seed_hashes(
        bases, lengths, c=C, k=K))
    packed = _pack_words(bases)
    h_b7, k_b7 = stage("B7 seed", lambda: seed_packed(packed, lengths, c=C,
                                                      k=K))
    h_b7, k_b7 = h_b7[:, :W], k_b7[:, :W]
    s_plain, s_b7 = int(k_plain.sum().item()), int(k_b7.sum().item())
    if s_plain != s_b7 or not torch.equal(
            torch.where(k_plain, h_plain, KEY_PAD),
            torch.where(k_b7, h_b7, KEY_PAD)):
        raise RuntimeError(f"stage_timing: B7 keeps {s_b7} survivors, the "
                           f"plain seeding {s_plain}, or other hashes")
    cap = compaction_cap(C)
    rows = stage("compact", lambda: compact_rows(h_b7, k_b7, 512, cap))
    kept = int((rows != KEY_PAD).sum().item())
    if kept != s_b7:
        raise RuntimeError(f"stage_timing: the compaction kept {kept} of "
                           f"{s_b7} survivors")
    _log(f"survivors: {s_b7} (plain {s_plain}, compacted {kept}); done")
    return dict(stages=out, survivors=s_b7, compacted=kept,
                shape=[n, L], cap=cap)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sylph_tpu_torch.stage_timing",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--reads", type=int, default=N,
                    help="reads of the [reads, 256] batch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        from .gpu._cuda import card_line
        print(card_line(), flush=True)
    print("stage_timing: " + json.dumps(run(dev, a.reps, a.reads)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
