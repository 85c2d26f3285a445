"""The harness end to end at the tiny sizes of tiny.py: a correct run, the
contract's result line, faults planted in the timed path coming out as
not correct, the control, the runs that must print no result, and a
configuration added as files only."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from perfbench import run
from perfbench.tests import faults, tiny

ROOT = tiny.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _mine(metrics, cell):
    return {m["name"] for m in metrics if cell in m.get("workloads", [cell])}


def _run(tmp_path, cell, *extra, device="cpu", seconds=1, trace=0,
         drop=(), src=ROOT):
    bench = tiny.write(str(tmp_path), drop, src)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(2**31 + 77),
                       "--seconds", str(seconds), "--trace", str(trace),
                       "--device", device, "--bench", bench, *extra])
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_reports_its_metrics(tmp_path, cell):
    rc, line = _run(tmp_path, cell, seconds=4)
    assert rc == 0 and line["correct"] is True
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == _mine(BENCH["end_to_end"], cell)
    assert all(v["value"] > 0 for k, v in line["metrics"].items()
               if k != "device_peak_gib")
    assert set(line["checks"]) == set(run.check.NAMES)


def test_traced_run_reads_its_per_layer_metrics(tmp_path):
    cell = CELLS[0]
    rc, line = _run(tmp_path, cell, trace=1)
    assert rc == 0 and line["correct"] is True
    mine = _mine(BENCH["per_layer"], cell)
    assert "sweep_retry_pct" in line["metrics"]
    assert set(line["metrics"]) <= mine
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    faults.FAULTS[fault](faults.driver_module(BENCH, ROOT, cell),
                         monkeypatch.setattr)
    rc, line = _run(tmp_path, cell)
    assert rc == 0 and line["correct"] is False
    assert 0 < line["failed"] <= line["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tmp_path, cell):
    """The reference in the program's place with its statistics in the
    precision below the configuration's (bfloat16 for float32) fails the
    statistics' limit."""
    rc, line = _run(tmp_path, cell, "--control")
    assert rc == 0 and line["correct"] is False
    gap = line["checks"]["stat_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("honour_cs", [True, False])
def test_a_failed_sweep_probe_is_swept_again(tmp_path, monkeypatch,
                                             honour_cs):
    """A sample whose sweep overflows a cell is swept again on the device
    with a larger cell capacity (or, where that fails too, on the
    per-chunk path), inside the window, and comes out correct."""
    from sylph_tpu_torch.gpu import grange
    orig = grange.GRangeEngine.plan_stream

    def plan_stream(self, t, n_matches=None, cs=None):
        P, CS, density = orig(self, t, n_matches, cs)
        return P, (cs if honour_cs and cs is not None else 1), density
    monkeypatch.setattr(grange.GRangeEngine, "plan_stream", plan_stream)
    cell = [c for c in CELLS if c.startswith("gtdb_r220.")][0]
    rc, line = _run(tmp_path, cell, trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["sweep_retry_pct"]["value"] == 100.0


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, line = _run(tmp_path, CELLS[0], device="cuda")
    assert rc != 0 and line is None


def test_forbidden_module_no_result(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line = _run(tmp_path, CELLS[0])
    assert rc != 0 and line is None


def test_imports_no_jax_and_no_jax_package():
    """Nothing the harness imports, every driver in perfbench/drivers/, each
    driver's bin hook and the port included, has the top-level name jax,
    jaxlib, flax or sylph_tpu (compared whole)."""
    mods = [f"perfbench.{pkg}.{f[:-3]}" for pkg in ("drivers", "tests.hooks")
            for f in sorted(os.listdir(os.path.join(
                ROOT, "perfbench", *pkg.split("."))))
            if f.endswith(".py") and f != "__init__.py"]
    assert {"perfbench.drivers.grange_sweep",
            "perfbench.drivers.merge_join"} <= set(mods)
    code = ("import sys, importlib, perfbench.run\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout
    names = set(eval(out))
    assert "sylph_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "sylph_tpu"}


def test_without_the_port_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ prints no
    result and exits non-zero."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "out",
                                                  "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                        "0", "--device", "cpu"], cwd=tmp_path,
                       capture_output=True, text=True,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""


NEW = "uhgg_v2_copy"


def _added(tmp_path, with_cut=True):
    """A copy of the benchmark's files under ``tmp_path/src`` with a
    configuration added as files only: uhgg_v2's file under a new name, its
    cut file, and its entry and one cell on an existing traffic in
    BENCHMARK.json. Returns (src, bench, the new cell)."""
    src = tmp_path / "src"
    shutil.copytree(os.path.join(ROOT, "perfbench"), src / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "out",
                                                  "__pycache__"))
    conf = src / "perfbench" / "configs"
    cfg = json.loads((conf / "uhgg_v2.json").read_text())
    (conf / f"{NEW}.json").write_text(json.dumps(dict(cfg, name=NEW)))
    if with_cut:
        cuts = src / tiny.CUTS
        shutil.copy(cuts / "uhgg_v2.json", cuts / f"{NEW}.json")
    bench = json.loads(json.dumps(BENCH))
    entry = {c["name"]: c for c in bench["configs"]}["uhgg_v2"]
    bench["configs"].append(dict(entry, name=NEW,
                                 file=f"perfbench/configs/{NEW}.json"))
    cell = f"{NEW}.wgs1g"
    bench["workloads"].append({"name": cell, "config": NEW,
                               "traffic": "wgs1g", "chips": 1,
                               "why": "a configuration added as files only"})
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    return src, bench, cell


@pytest.mark.parametrize("mode", ["correct", "control",
                                  *sorted(faults.FAULTS)])
def test_a_configuration_added_as_files_only_runs(tmp_path, monkeypatch,
                                                  mode):
    """A configuration added by new files and BENCHMARK.json entries alone
    runs its tiny cell correct, and its control and each fault not
    correct."""
    src, bench, cell = _added(tmp_path)
    extra = ("--control",) if mode == "control" else ()
    if mode in faults.FAULTS:
        faults.FAULTS[mode](faults.driver_module(bench, str(src), cell),
                            monkeypatch.setattr)
    rc, line = _run(tmp_path / "run", cell, *extra, src=str(src))
    assert rc == 0 and line["correct"] is (mode == "correct")
    if mode == "control":
        gap = line["checks"]["stat_gap"]
        assert gap["value"] > gap["limit"]
    elif mode in faults.FAULTS:
        assert 0 < line["failed"] <= line["attempted"]
    else:
        assert line["attempted"] > 0 and line["failed"] == 0
        assert set(line["metrics"]) == _mine(bench["end_to_end"], cell)


def test_a_configuration_without_a_cut_file_is_refused(tmp_path):
    src, _bench, _cell = _added(tmp_path, with_cut=False)
    with pytest.raises(FileNotFoundError,
                       match=f"cuts/{NEW}\\.json is missing"):
        tiny.write(str(tmp_path / "run"), src=str(src))


def test_a_driver_without_a_bin_hook_raises(monkeypatch):
    mod = types.ModuleType("perfbench.drivers.no_hook")
    with pytest.raises(FileNotFoundError,
                       match="hooks/no_hook\\.py is missing"):
        faults.bin(mod, monkeypatch.setattr)


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tmp_path, cuda_device):
    for cell in CELLS:
        rc, line = _run(tmp_path, cell, device="cuda", trace=1,
                        drop=tiny.card_drop(BENCH, cell))
        assert rc == 0 and line["correct"] is True
        assert line["device"]["platform"] == "gpu"
        assert line["device"]["busy_s"] > 0
