"""The host engine's golden TSV of a bench fixture (counterpart of
scripts/gtdb_cli_host_golden.py), and the card's TSV held to it.

    python -m sylph_tpu_torch.host_golden [--db D] [--reads R] [--out O]
        [--device cuda|cpu | --golden-only] [--debug]
    python -m sylph_tpu_torch.host_golden --e2e [--paired] [...]

``profile`` of the fixture on the host engine (``device="host"``: the
native C seeder, host probes and statistics, no GPU and no kernel, at -t
4), written to ``O.tmp`` and renamed to ``O``; it prints its rows and
seconds. The device run must be byte-identical: unless ``--golden-only``,
the same profile then runs on ``--device`` (default the GPU; it raises
without one unless the CPU is asked for) and its TSV must equal the
golden byte for byte, or the tool exits non-zero; both times are printed.
``--debug`` logs every stage_timer record on stderr (the host run's split:
load, sketch, the prefilter's host probes, pass 1 and pass 2).

Defaults: the gtdb_cli fixture, .bench_data/gtdb_cli/{db.syldb,
reads.fastq.gz} -> golden_host.tsv (python -m
sylph_tpu_torch.bench_fixtures gtdb_cli); with ``--e2e``,
.bench_data/e2e/{db.syldb, reads.fastq.gz} -> golden_host.tsv, or with
``--paired`` reads_R1/R2.fastq.gz -> golden_host_paired.tsv.
"""

import argparse
import io
import json
import os
import sys
import time
from typing import Optional

from .bench import DATA
from .engine.runner import HOST, ContainOptions, contain, engine_device


def _options(db: str, reads, device) -> ContainOptions:
    if len(reads) == 2:
        return ContainOptions(files=[db], first_pair=[reads[0]],
                              second_pair=[reads[1]], threads=4,
                              device=device)
    return ContainOptions(files=[db, reads[0]], threads=4, device=device)


def write_golden(db: str, reads, out_path: str) -> dict:
    """Profile ``reads`` (one file, or a pair) against ``db`` on the host
    engine into ``out_path`` (through ``out_path``.tmp); returns its rows
    and seconds."""
    t0 = time.perf_counter()
    with open(out_path + ".tmp", "w") as out:
        contain(_options(db, reads, HOST), pseudotax=True, out=out)
    os.replace(out_path + ".tmp", out_path)
    with open(out_path) as f:
        rows = sum(1 for _ in f) - 1
    return dict(rows=rows, seconds=time.perf_counter() - t0)


def main(argv: Optional[list] = None) -> int:
    if argv is None:
        from .cli import _tune_allocator
        _tune_allocator("sylph_tpu_torch.host_golden")
    ap = argparse.ArgumentParser(prog="python -m sylph_tpu_torch.host_golden",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--paired", action="store_true")
    ap.add_argument("--db", default=None)
    ap.add_argument("--reads", nargs="+", default=None,
                    help="a read file, or the two files of a pair")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--golden-only", dest="golden_only", action="store_true",
                    help="write the golden; run no device comparison")
    ap.add_argument("--debug", action="store_true",
                    help="log the stage timers on stderr")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if a.debug:
        from .cli import _setup_logging
        _setup_logging(debug=True)
    if a.paired and not a.e2e:
        ap.error("--paired goes with --e2e")
    d = os.path.join(DATA, "e2e" if a.e2e else "gtdb_cli")
    db = a.db or os.path.join(d, "db.syldb")
    if a.reads:
        reads = a.reads
    elif a.paired:
        reads = [os.path.join(d, "reads_R1.fastq.gz"),
                 os.path.join(d, "reads_R2.fastq.gz")]
    else:
        reads = [os.path.join(d, "reads.fastq.gz")]
    if len(reads) > 2:
        ap.error("--reads takes one file or the two files of a pair")
    out_path = a.out or os.path.join(
        d, "golden_host_paired.tsv" if len(reads) == 2 else
        "golden_host.tsv")
    missing = [p for p in [db, *reads] if not os.path.exists(p)]
    if missing:
        raise SystemExit(f"{missing} not found (python -m sylph_tpu_torch."
                         "bench_fixtures " + ("e2e" + (" --paired" if a.paired
                                                      else "")
                                              if a.e2e else "gtdb_cli")
                         + " makes them)")
    dev = None if a.golden_only else engine_device(a.device)
    if dev is not None and dev.type == "cuda":
        from .gpu._cuda import card_line
        print(card_line(), flush=True)
    g = write_golden(db, reads, out_path)
    print(f"host golden: {g['rows']} rows in {g['seconds']:.1f} s -> "
          f"{out_path}", flush=True)
    rec = dict(golden=out_path, host_rows=g["rows"], host_s=g["seconds"])
    if dev is not None:
        t0 = time.perf_counter()
        out = io.StringIO()
        contain(_options(db, reads, dev), pseudotax=True, out=out)
        rec.update(device=str(dev), device_s=time.perf_counter() - t0)
        with open(out_path) as f:
            rec["equal"] = out.getvalue() == f.read()
        print(f"{dev} run: {rec['device_s']:.1f} s, TSV "
              f"{'equal to' if rec['equal'] else 'DIFFERENT from'} the "
              "host golden", flush=True)
    print("host_golden: " + json.dumps(rec), flush=True)
    return 0 if rec.get("equal", True) else 1


if __name__ == "__main__":
    sys.exit(main())
