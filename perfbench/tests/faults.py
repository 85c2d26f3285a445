"""Faults planted in the timed path, each of which the check has to find:
the tests plant them at the sizes of tiny.py; on a card,

    python3 -m perfbench.tests.faults --fault half --workload CELL \
        --seed N --seconds S --trace 0

runs a cell of BENCHMARK.json at its own size with one of them planted
and prints the run's result line (``correct`` has to read false).

  stale  the step returns its state unchanged: each result is the one
         before it
  half   half of each sample's batches left out
  bin    one histogram bin altered where the join produces it (genome 0,
         multiplicity 1), by the driver's own hook: hooks/<driver>.py,
         ``bin(patch)``; a driver without one raises
"""

import importlib
import json
import os
import sys

HOOKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hooks")


def stale(mod, patch):
    orig = mod.Driver.finish
    last = []

    def finish(self, p, spans):
        last.append(orig(self, p, spans))
        return last[-2] if len(last) > 1 else last[-1]
    patch(mod.Driver, "finish", finish)


def half(mod, patch):
    orig = mod.Driver.dispatch

    def dispatch(self, packed, lengths, spans, keep):
        return orig(self, packed[:max(1, packed.shape[0] // 2)], lengths,
                    spans, keep)
    patch(mod.Driver, "dispatch", dispatch)


def bin(mod, patch):  # noqa: A001
    """The bin hook of the cell's driver, hooks/<driver>.py."""
    name = mod.__name__.rsplit(".", 1)[-1]
    path = os.path.join(HOOKS, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"the driver {name!r} has no bin hook: {path} is missing")
    importlib.import_module(f"perfbench.tests.hooks.{name}").bin(patch)


FAULTS = {"stale": stale, "half": half, "bin": bin}


def driver_module(bench: dict, root: str, cell: str):
    """The driver module of a cell of ``bench``."""
    name = {w["name"]: w for w in bench["workloads"]}[cell]["config"]
    entry = {c["name"]: c for c in bench["configs"]}[name]
    with open(os.path.join(root, entry["file"])) as f:
        return importlib.import_module(
            f"perfbench.drivers.{json.load(f)['driver']}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--fault")
    fault = argv[i + 1]
    del argv[i:i + 2]
    from perfbench import run
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = argv[argv.index("--workload") + 1]
    FAULTS[fault](driver_module(bench, run.ROOT, cell), setattr)
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
