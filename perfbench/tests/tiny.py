"""A copy of BENCHMARK.json's cells at sizes a CPU test holds: the real
configuration and traffic files with their scale cut, written under a
test's temporary directory. Each configuration's cut is a file of its own,
cuts/<config>.json: ``index``, the index keys it sets, and
``read_nothing_on_card``, the per-layer metrics that read nothing at these
sizes on a card."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CUTS = os.path.join("perfbench", "tests", "cuts")
TRAFFIC = {"batches": 2, "reads_per_batch": 4096, "pool_samples": 2,
           "present_genomes": 2, "coverage": [0.5, 1.5],
           "filler_rows": 2048, "trace_samples": 2}


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cut(config: str, src: str = ROOT) -> dict:
    """The cut of ``config`` under ``src``; a configuration without a cut
    file raises, naming the file."""
    path = os.path.join(src, CUTS, config + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"the configuration {config!r} has no tiny cut: {path} is missing")
    return _load(path)


def card_drop(bench: dict, cell: str, src: str = ROOT) -> list:
    """The per-layer metrics that ``cell`` of ``bench`` reads nothing of at
    the tiny sizes on a card."""
    config = {w["name"]: w for w in bench["workloads"]}[cell]["config"]
    return cut(config, src)["read_nothing_on_card"]


def write(tmp, drop=(), src: str = ROOT) -> str:
    """The path of a tiny BENCHMARK.json under ``tmp``, made from the
    benchmark's files under ``src``, without the per-layer metrics named in
    ``drop``."""
    bench = _load(os.path.join(src, "BENCHMARK.json"))
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if m["name"] not in drop]
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(tmp, "perfbench", sub), exist_ok=True)
    for c in bench["configs"]:
        cfg = _load(os.path.join(src, c["file"]))
        cfg["index"].update(cut(c["name"], src)["index"])
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name in {w["traffic"] for w in bench["workloads"]}:
        path = os.path.join("perfbench", "traffic", name + ".json")
        traffic = _load(os.path.join(src, path))
        traffic.update(TRAFFIC)
        with open(os.path.join(tmp, path), "w") as f:
            json.dump(traffic, f)
    out = os.path.join(tmp, "BENCHMARK.json")
    with open(out, "w") as f:
        json.dump(bench, f)
    return out
