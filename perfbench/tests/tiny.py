"""A copy of BENCHMARK.json's cells at sizes a CPU test holds: the real
configuration and traffic files with their scale cut, written under a
test's temporary directory."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CUTS = {
    "gtdb_r220": {"genomes": 64, "kmers_per_genome": 2048,
                  "chunk_slots": 1 << 14, "plantable_genomes": 8},
    "uhgg_v2": {"genomes": 32, "kmers_per_genome": 1024},
}
TRAFFIC = {"batches": 2, "reads_per_batch": 4096, "pool_samples": 2,
           "present_genomes": 2, "coverage": [0.5, 1.5],
           "filler_rows": 2048, "trace_samples": 2}


def write(tmp, drop=()) -> str:
    """The path of a tiny BENCHMARK.json under ``tmp``, without the
    per-layer metrics named in ``drop``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if m["name"] not in drop]
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(tmp, "perfbench", sub), exist_ok=True)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["index"].update(CUTS[c["name"]])
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name in {w["traffic"] for w in bench["workloads"]}:
        path = os.path.join("perfbench", "traffic", name + ".json")
        with open(os.path.join(ROOT, path)) as f:
            traffic = json.load(f)
        traffic.update(TRAFFIC)
        with open(os.path.join(tmp, path), "w") as f:
            json.dump(traffic, f)
    out = os.path.join(tmp, "BENCHMARK.json")
    with open(out, "w") as f:
        json.dump(bench, f)
    return out
