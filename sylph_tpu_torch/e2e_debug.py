"""One instrumented file-to-TSV profile run (counterpart of
scripts/e2e_debug.py).

    python -m sylph_tpu_torch.e2e_debug [--db D] [--reads R | --paired
        [--r1 R1 --r2 R2]] [--runs 2] [--device cuda|cpu]

Runs ``profile`` of the e2e fixture (python -m
sylph_tpu_torch.bench_fixtures e2e [--paired]: .bench_data/e2e/db.syldb
and reads.fastq.gz, or reads_R1/R2.fastq.gz) ``--runs`` times with the
``sylph`` logger at DEBUG on stderr: every stage_timer record and the
ingest's per-phase busy seconds ([ingest]), then each run's wall seconds
and TSV lines. Then one run with the logger at WARNING. Check, raising on
failure: every instrumented run's TSV equals the uninstrumented run's.
"""

import argparse
import io
import json
import logging
import os
import sys
import time
from typing import Optional

from .bench import DATA
from .engine.runner import ContainOptions, contain
from .gpu.grange import resolve_device

E2E = os.path.join(DATA, "e2e")


def _profile(a, device) -> str:
    out = io.StringIO()
    if a.paired:
        opts = ContainOptions(files=[a.db], first_pair=[a.r1],
                              second_pair=[a.r2], threads=4, device=device)
    else:
        opts = ContainOptions(files=[a.db, a.reads], threads=4,
                              device=device)
    contain(opts, pseudotax=True, out=out)
    return out.getvalue()


def main(argv: Optional[list] = None) -> int:
    if argv is None:
        from .cli import _tune_allocator
        _tune_allocator("sylph_tpu_torch.e2e_debug")
    ap = argparse.ArgumentParser(prog="python -m sylph_tpu_torch.e2e_debug",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--db", default=os.path.join(E2E, "db.syldb"))
    ap.add_argument("--reads", default=os.path.join(E2E, "reads.fastq.gz"))
    ap.add_argument("--paired", action="store_true")
    ap.add_argument("--r1", default=os.path.join(E2E, "reads_R1.fastq.gz"))
    ap.add_argument("--r2", default=os.path.join(E2E, "reads_R2.fastq.gz"))
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(a.device)
    need = [a.db] + ([a.r1, a.r2] if a.paired else [a.reads])
    missing = [p for p in need if not os.path.exists(p)]
    if missing:
        raise SystemExit(f"{missing} not found (python -m "
                         "sylph_tpu_torch.bench_fixtures e2e"
                         + (" --paired" if a.paired else "") + " makes them)")
    if dev.type == "cuda":
        from .gpu._cuda import card_line
        print(card_line(), flush=True)
    lg = logging.getLogger("sylph")
    old = lg.level
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    runs = []
    lg.addHandler(h)
    try:
        lg.setLevel(logging.DEBUG)
        for i in range(a.runs):
            t0 = time.perf_counter()
            tsv = _profile(a, dev)
            dt = time.perf_counter() - t0
            runs.append((dt, tsv))
            print(f"### run {i}: {dt:.2f} s ({len(tsv.splitlines())} TSV "
                  "lines)", flush=True)
        lg.setLevel(logging.WARNING)
        t0 = time.perf_counter()
        plain = _profile(a, dev)
        plain_s = time.perf_counter() - t0
    finally:
        lg.setLevel(old)
        lg.removeHandler(h)
    bad = [i for i, (_dt, tsv) in enumerate(runs) if tsv != plain]
    if bad:
        raise RuntimeError(f"e2e_debug: instrumented runs {bad} differ from "
                           "the uninstrumented run's TSV")
    print("e2e_debug: " + json.dumps(dict(
        runs_s=[dt for dt, _ in runs], plain_s=plain_s,
        lines=len(plain.splitlines()), equal=True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
