"""The benchmark of sylph_tpu_torch, the PyTorch and CUDA port of sylph on
one NVIDIA H100: many read samples profiled, one after another, against
one resident genome database.

    python3 -m perfbench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. A run reads its cell in BENCHMARK.json, the
cell's configuration (perfbench/configs/) and traffic mix
(perfbench/traffic/), makes the database and a pool of read samples on
the card from ``--seed``, loads the database into the port through the
configuration's driver (perfbench/drivers/), warms up on every sample of
the pool, then keeps ``depth`` samples in flight for ``--seconds``
seconds (a closed loop of one client). The device's memory peak is read
over the warm-up and the window. Then ``check_runs`` more samples go
through the same loop with their seeding output and histograms kept for
the check. With ``--trace 0`` it prints the cell's end-to-end metrics;
with ``--trace 1`` it measures the same window, then profiles
``trace_samples`` more samples with torch.profiler and prints the cell's
per-layer metrics (perfbench/metrics/), the device's busy time and a
breakdown; on a card, a per-layer metric of the cell that reads nothing
ends the run with no result. Either way it then checks every result
against the plain reference (perfbench/reference/, check.py) and prints
each number compared beside its limit, on standard error and as the last
key of its one JSON line on standard output.

A run needs the cell's chips and exits non-zero without them; ``--device
cpu`` runs it on the CPU at the small sizes of the tests. ``--control``
puts the reference, computed in the precision below the configuration's,
in the program's place (no window) and prints the numbers it gives.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of the program, at a fixed path in the
# checkout (the port builds csrc/ into ROOT/build/kernels itself)
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, "cache",
                                                  "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check  # noqa: E402
from perfbench.bounds.arith import bound_s  # noqa: E402
from perfbench.gen import reads  # noqa: E402
from perfbench.reference import join as ref_join  # noqa: E402
from perfbench.reference import sketch as ref_sketch  # noqa: E402
from perfbench.reference import stats as ref_stats  # noqa: E402
from perfbench.result import Result  # noqa: E402
from perfbench.trace import Spans, TraceView  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sylph_tpu")
GIB = float(1 << 30)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules():
    """Top-level names of loaded modules that the port may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card(dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}


def card_limits() -> str:
    """The card's name, power limit and top SM clock (nvidia-smi)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def launches():
    from sylph_tpu_torch.gpu import _cuda
    return dict(_cuda.LAUNCHES)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


class Loop:
    """A closed loop of one client: ``depth`` samples in flight, each one's
    calls dispatched while the one before it is still running; a sample
    is done when its result is on the host."""

    def __init__(self, driver, pool, depth: int):
        self.driver, self.pool, self.depth = driver, pool, depth

    def run(self, spans, n=None, seconds=None, keep=(), first: int = 0):
        """[(run, pool sample, start, done, Result)] of ``n`` samples, or of
        every sample started within ``seconds``; the window's (start,
        end)."""
        drv, pool = self.driver, self.pool
        out, flying = [], deque()
        t0 = time.perf_counter()
        t_end = None if seconds is None else t0 + seconds
        i = 0
        while (n is None or i < n) and (
                t_end is None or time.perf_counter() < t_end):
            s = (first + i) % pool.samples
            start = time.perf_counter()
            flying.append((i, s, start, drv.dispatch(
                pool.packed[s], pool.lengths, spans, keep=i in keep)))
            i += 1
            if len(flying) >= self.depth:
                out.append(self._finish(flying.popleft(), spans))
        while flying:
            out.append(self._finish(flying.popleft(), spans))
        return out, (t0, t_end if t_end is not None else time.perf_counter())

    def _finish(self, item, spans):
        i, s, start, pending = item
        res = self.driver.finish(pending, spans)
        return i, s, start, time.perf_counter(), res


def reference(driver, pool, used, H: int) -> SimpleNamespace:
    """The plain reference of the pool samples in ``used``: each one's
    sketch and histogram, the genomes' k-mer counts, and the index k-mers
    each sample holds, by chunk."""
    k, c = driver.k, driver.c
    sk = {s: ref_sketch.sketch_sample(pool.packed[s], pool.lengths, c=c, k=k)
          for s in used}
    hists, n_kmers, matched = ref_join.histograms(
        driver.index, [sk[s] for s in used], H)
    return SimpleNamespace(
        used=used, sketches=sk, all_hists=hists, n_kmers=n_kmers,
        hists={s: hists[j] for j, s in enumerate(used)},
        matched={s: matched[j] for j, s in enumerate(used)})


def ref_statistics(ref, k: int, dtype=torch.float64) -> dict:
    """{pool sample: {field: host array}} of the reference's statistics."""
    st = ref_stats.genome_stats(ref.all_hists, ref.n_kmers, k=k, dtype=dtype)
    return {s: {f: v[j].to(torch.float64 if v.is_floating_point()
                           else torch.int64).cpu().numpy()
                for f, v in st.items()} for j, s in enumerate(ref.used)}


def control(driver, pool, cfg) -> dict:
    """The reference in the program's place, its statistics computed in the
    precision below the configuration's: the numbers it gives against the
    reference proper, over every sample of the pool."""
    lower = {"float32": torch.bfloat16, "float64": torch.float32}[
        cfg["stats"]["precision"]]
    ref = reference(driver, pool, list(range(pool.samples)), driver.H)
    want = ref_statistics(ref, driver.k)
    got = ref_statistics(ref, driver.k, dtype=lower)
    return check.compare([(s, Result(got[s])) for s in ref.used], want,
                         ref.sketches, ref.hists)


def e2e_metrics(rec, t_end, pool, setup_s, peak, seconds) -> dict:
    done = sum(1 for r in rec if r[3] <= t_end)
    return {"profile_gbps": done * pool.bases / seconds / 1e9,
            "device_peak_gib": peak / GIB, "setup_s": setup_s}


def layer_metrics(names, ctx):
    """({metric: number}, [metrics that read nothing]) from each metric's
    reader, perfbench/metrics/<name>.py (``read(ctx)``: the number, or
    None where it finds nothing to read)."""
    out, missing = {}, []
    for name in names:
        spec = importlib.util.spec_from_file_location(
            f"perfbench.metrics._{len(out)}",
            os.path.join(HERE, "metrics", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(ctx)
        if v is None:
            missing.append(name)
        else:
            out[name] = float(v)
    return out, missing


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--bench", default=os.path.join(ROOT, "BENCHMARK.json"),
                    help="the benchmark file; configurations and traffic "
                    "are read beside it")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse(argv)
    bench = _load(a.bench)
    base = os.path.dirname(os.path.abspath(a.bench))
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        log(f"no workload {a.workload!r} in {a.bench}")
        return 2
    cell = cells[a.workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = _load(os.path.join(base, entry["file"]))
    traffic = _load(os.path.join(base, "perfbench", "traffic",
                                 cell["traffic"] + ".json"))
    if a.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            log(f"{a.workload} needs {cell['chips']} CUDA device(s); "
                f"{torch.cuda.device_count()} available")
            return 3
        dev = torch.device("cuda", 0)
        # one host thread issues the work; no CPU op pool competes with it
        torch.set_num_threads(1)
        log(f"card: {card_limits()}")
    else:
        dev = torch.device("cpu")
    try:
        driver_mod = importlib.import_module(
            f"perfbench.drivers.{cfg['driver']}")
    except ImportError as e:
        log(f"cannot load the driver {cfg['driver']!r}: {e}")
        return 2

    driver = driver_mod.Driver(cfg, dev)
    t = time.perf_counter()
    pool = reads.make_pool(driver.index, traffic, a.seed, dev)
    _sync(dev)
    log(f"pool: {pool.samples} samples of {pool.bases} bases, "
        f"{time.perf_counter() - t:.3f} s")
    if a.control:
        numbers = control(driver, pool, cfg)
        return _report(False, numbers, cfg, {}, card(dev), None, 0, 0)
    t = time.perf_counter()
    driver.load()
    _sync(dev)
    log(f"load: {time.perf_counter() - t:.3f} s")
    if dev.type == "cuda":
        # the peak counts what serving holds: the database, the pool and
        # the port's working memory, not the generators' transients
        torch.cuda.reset_peak_memory_stats(dev)
    loop = Loop(driver, pool, traffic["depth"])
    off = Spans(False)
    t = time.perf_counter()
    loop.run(off, n=pool.samples)
    _sync(dev)
    log(f"warm-up ({pool.samples} samples): {time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - T_START

    l0 = launches()
    gc.collect()
    gc.disable()              # no collector pause inside the window
    rec, (_t0, t_end) = loop.run(off, seconds=a.seconds)
    gc.enable()
    win_launches = _delta(launches(), l0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    dev_info = dict(card(dev), memory_peak_bytes=int(peak))
    log(f"window: {len(rec)} samples in {a.seconds} s, peak "
        f"{peak / GIB:.3f} GiB, launches {win_launches}")
    if rec:
        lat = np.array([(r[3] - r[2]) * 1e3 for r in rec])
        gap = np.diff([r[2] for r in rec]) * 1e3
        log("latency ms p50/p90/p95/p99/max: " + " ".join(
            f"{x:.1f}" for x in np.percentile(lat, [50, 90, 95, 99, 100]))
            + "; between starts ms p50/p95/max: " + " ".join(
            f"{x:.1f}" for x in (np.percentile(gap, [50, 95, 100])
                                 if gap.size else [0, 0, 0])))
    # the kept runs: the same loop, after the peak is read, so that what
    # the check holds is not counted in it
    n_keep = traffic["check_runs"]
    kept, _w = loop.run(off, n=n_keep, keep=set(range(n_keep)),
                        first=len(rec))

    tv = traced = None
    if a.trace:
        from torch.profiler import ProfilerActivity, profile
        on = Spans(True)
        driver.instrument(on)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        l1 = launches()
        with profile(activities=acts) as prof:
            traced, _w = loop.run(on, n=traffic["trace_samples"],
                                  first=len(rec) + n_keep)
            _sync(dev)
        trace_launches = _delta(launches(), l1)
        driver.instrument(None)
        t = time.perf_counter()
        tv = TraceView(prof.events())
        del prof
        log(f"trace read: {time.perf_counter() - t:.3f} s")
    driver.unload()
    results = [(r[1], r[4]) for r in rec + kept + (traced or [])]
    del loop
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    used = sorted({s for s, _ in results})
    ref = reference(driver, pool, used, driver.H)
    numbers = check.compare(results, ref_statistics(ref, driver.k),
                            ref.sketches, ref.hists)
    log(f"reference over {len(used)} samples: "
        f"{time.perf_counter() - t:.3f} s")
    done = [r for _, r in results if r is not None]
    log(f"of {len(done)} compared runs, {sum(r.retried for r in done)} "
        f"failed the sweep's probe and were swept again, "
        f"{sum(r.fallback for r in done)} of them on the per-chunk path")

    names = [m["name"] for m in bench["per_layer"]
             if a.workload in m.get("workloads", [a.workload])]
    if a.trace:
        work = {}
        for r in traced:
            for kname, lst in driver.kernel_work(
                    ref.sketches[r[1]], ref.matched[r[1]], pool.lengths,
                    pool.packed.shape[1], pool.packed.shape[3] * 16,
                    retried=r[4] is not None and r[4].retried).items():
                work.setdefault(kname, []).extend(lst)
        for kname, lst in work.items():
            t_min, which = bound_s(sum(b for b, _ in lst),
                                   sum(c for _, c in lst))
            log(f"{kname}: {len(lst)} launches need {t_min * 1e3:.4f} ms, "
                f"bound by {which} (H100 data-sheet peaks; the card's "
                "power limit is on the first line)")
        ctx = SimpleNamespace(
            trace=tv, traced_samples=len(traced), work=work,
            trace_launches=trace_launches, launches=win_launches,
            window_samples=len(rec),
            window_results=[r[4] for r in rec],
            latencies_ms=[(r[3] - r[2]) * 1e3 for r in rec])
        metrics, missing = layer_metrics(names, ctx)
        if missing and dev.type == "cuda":
            log(f"per-layer metrics of {a.workload} read nothing: {missing} "
                "(a span, kernel or counter they read is gone from the "
                "traced window)")
            return 5
        if missing:
            log(f"left out on the CPU, which has no device timeline: "
                f"{missing}")
        dev_info.update(busy_s=tv.busy_s, window_s=tv.window_s)
        breakdown = tv.breakdown()
    else:
        mine = {m["name"] for m in bench["end_to_end"]
                if a.workload in m.get("workloads", [a.workload])}
        metrics = {k: v for k, v in e2e_metrics(
            rec, t_end, pool, setup_s, peak, a.seconds).items() if k in mine}
        breakdown = None
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in metrics.items()}
    return _report(True, numbers, cfg, metrics, dev_info, breakdown,
                   len(results), numbers["wrong_runs"])


def _report(program: bool, numbers, cfg, metrics, dev_info, breakdown,
            attempted: int, failed: int) -> int:
    found = forbidden_modules()
    if found:
        log(f"modules the port may not load are loaded: {found}")
        return 4
    limits = cfg["limits"]
    checks = {n: {"value": numbers[n], "limit": limits[n]}
              for n in check.NAMES}
    ok = check.verdict(numbers, limits) and failed == 0
    for n, v in checks.items():
        log(f"check {n}: {v['value']} (limit {v['limit']})")
    line = {"correct": ok, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if not program:
        line["control"] = True
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
