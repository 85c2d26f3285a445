"""The port's spans and host waits (sylph_tpu_torch/utils/timing.py) on the
per-sample paths: seeding (``sketch_batch_packed``), the grange fold and
stream sweep (``fold_stream``, ``hist_device_stream``), the per-chunk
sweep (``GRangeEngine.hists``), the merge join (``finish_profile``) and
the statistics (``stats_from_histograms``).

With no profiler a span is one shared no-op and nothing is kept; under
``torch.profiler`` each span is a CPU-only ``sylph.<name>`` range (no user
annotation, so no copy on the device timeline) with an in-memory record,
and the results are the same bits either way. The test marked ``cuda``
runs every path on the card under ``torch.cuda.set_sync_debug_mode("warn")``
and holds each synchronizing call inside a ``wait``. The file imports
neither jax nor sylph_tpu; on a machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_trace.py
"""

import logging
import threading
import time
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sylph_tpu_torch.gpu import grange as gr
from sylph_tpu_torch.gpu import pipeline as pl
from sylph_tpu_torch.gpu.stats import stats_from_histograms
from sylph_tpu_torch.utils import timing

G, K, C = 50, 31, 200


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_records():
    timing.reset()
    yield
    timing.reset()


class World:
    """A small grange index (nt = 4), the same keys as a flat merge index,
    a sample table and its occurrence stream (with pads), and a packed
    read batch, all made by numpy from one seed."""

    def __init__(self, dev, m=60_000, seed=3):
        rng = np.random.default_rng(seed)
        thr = ((1 << 64) - 1) // 20
        self.kmers = rng.integers(0, thr, size=m, dtype=np.uint64)
        self.gids = rng.integers(0, G, size=m).astype(np.int32)
        sk = np.unique(np.concatenate([
            rng.choice(self.kmers, size=2500),
            rng.integers(0, thr, size=2500, dtype=np.uint64)]))
        self.sk = sk
        self.sc = rng.integers(1, 40, size=sk.size).astype(np.uint32)
        occ = np.repeat(sk.view(np.int64), np.minimum(self.sc, 5))
        occ = np.concatenate([rng.permutation(occ), np.full(777, -1)])
        self.stream = torch.from_numpy(occ).to(dev)
        idx = gr.build_grange_index(self.kmers, self.gids, G,
                                    chunk_slots=1 << 14, target_mean=512,
                                    nt=4, device=dev)
        self.engine = gr.GRangeEngine(idx, device=dev)
        self.n_chunks = len(idx.chunk_keys)
        self.idx_key = torch.from_numpy(self.kmers.view(np.int64)).to(dev)
        self.idx_gid = torch.from_numpy(self.gids).to(dev)
        self.n_kmers = torch.bincount(self.idx_gid.to(torch.int64),
                                      minlength=G).to(torch.int32)
        codes = rng.integers(0, 4, size=(512, 256)).astype(np.uint8)
        # the statistics' input, made with no profiler running
        self.hist = torch.from_numpy(self.engine.hists(sk, self.sc)).to(dev)
        self.packed = torch.from_numpy(
            pl.pack_bases_u32(codes).view(np.int32)).to(dev)
        self.lengths = torch.full((512,), 150, dtype=torch.int32, device=dev)
        self.dev = dev


_WORLDS = {}


def _world(dev="cpu") -> World:
    if dev not in _WORLDS:
        _WORLDS[dev] = World(torch.device(dev))
    return _WORLDS[dev]


# one call of each path -> its results (tensors, or a numpy histogram)
def _seed(w):
    return pl.sketch_batch_packed(w.packed, w.lengths, c=C, k=K,
                                  device=w.dev)


def _sweep(w):
    skey, wt = gr.fold_stream(w.stream)
    return w.engine.hist_device_stream(skey, wt)[:2]


def _chunks(w):
    return (torch.from_numpy(w.engine.hists(w.sk, w.sc)),)


def _join(w):
    hist, st = pl.finish_profile(w.stream, w.idx_key, w.idx_gid, w.n_kmers,
                                 k=K, n_genomes=G, n_buckets=64,
                                 device=w.dev)
    return (hist, *st)


def _stats(w):
    return tuple(stats_from_histograms(w.hist, w.n_kmers, k=K,
                                       min_ani=0.95))


PATHS = {"seed": _seed, "sweep": _sweep, "sweep.chunks": _chunks,
         "join": _join, "stats": _stats}

# the spans each path yields, and the parent of each (None: a root)
PARENTS = {
    "seed": {"seed": None, "seed.unpack": "seed", "seed.pack": "seed"},
    "sweep": {"fold": None, "fold.mask": "fold", "fold.unique": "fold",
              "sweep": None, "sweep.plan": "sweep", "sweep.chunk": "sweep",
              "sweep.fill": "sweep.chunk", "sweep.join": "sweep.chunk",
              "sweep.repack": "sweep.chunk", "sweep.hist": "sweep",
              "sweep.bincount": "sweep.hist"},
    "sweep.chunks": {"sweep.chunks": None, "sweep.upload": "sweep.chunks",
                     "sweep.fill": "sweep.chunks",
                     "sweep.join": "sweep.chunks",
                     "sweep.repack": "sweep.chunks",
                     "sweep.probe": "sweep.chunks",
                     "sweep.bincount": "sweep.chunks",
                     "sweep.fetch": "sweep.chunks"},
    "join": {"join": None, "join.bincount": "join", "stats": None},
    "stats": {"stats": None},
}
WAITS = {"fold.mask", "fold.unique", "sweep.bincount", "sweep.upload",
         "sweep.probe", "sweep.fetch", "join.bincount"}


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof.events()


def _same(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def test_span_off_is_the_shared_noop():
    assert timing.span("seed") is timing.wait("fold.mask") is timing._NOOP
    with timing.span("a"), timing.wait("b"):
        pass
    assert timing.records() == []


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_profiler_keeps_no_record(path):
    PATHS[path](_world())
    assert timing.records() == [] and timing.summary() == {}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_profiled_path_yields_its_spans_nested(path):
    w = _world()
    _out, events = _profiled(PATHS[path], w)
    recs = timing.records()
    by_id = {r.id: r for r in recs}
    names = {r.name for r in recs}
    assert names == set(PARENTS[path])
    for r in recs:
        want = PARENTS[path][r.name]
        got = by_id[r.parent].name if r.parent is not None else None
        assert got == want, r
        assert r.wait == (r.name in WAITS)
        assert r.end_ns >= r.start_ns
        assert r.thread == threading.get_ident()
        root = r
        while root.parent is not None:
            root = by_id[root.parent]
        assert r.root == root.id
    # one root id a top-level call, shared by all of its spans
    roots = [r for r in recs if r.parent is None]
    assert len({r.root for r in recs}) == len(roots)
    if path == "sweep":
        n_chunk = sum(r.name == "sweep.chunk" for r in recs)
        assert n_chunk == w.n_chunks > 1
        for part in ("sweep.fill", "sweep.join", "sweep.repack"):
            assert sum(r.name == part for r in recs) == w.n_chunks
    # the profiler saw the same spans, each a CPU range, no user annotation
    ours = [e for e in events if e.name.startswith(timing.PREFIX)]
    assert sorted(e.name for e in ours) == sorted(
        timing.PREFIX + r.name for r in recs)
    for e in ours:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation


def _disagreements(events, summ):
    """Span names whose summary() host ms differ from the profiler's
    durations of their ``sylph.`` ranges by more than 5% plus 20 µs a
    span."""
    prof_us = {}
    for e in events:
        if e.name.startswith(timing.PREFIX):
            name = e.name[len(timing.PREFIX):]
            prof_us[name] = prof_us.get(name, 0.0) + (
                e.time_range.end - e.time_range.start)
    assert set(summ) == set(prof_us)
    return [(name, s["host_ms"], prof_us[name] / 1e3)
            for name, s in summ.items()
            if abs(s["host_ms"] - prof_us[name] / 1e3)
            > 0.05 * prof_us[name] / 1e3 + 0.020 * s["count"]]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_summary_agrees_with_profiler_durations(path):
    """A record's host times lie just inside its profiler range. A thread
    descheduled inside the profiler's own entry or exit (a shared CPU)
    lengthens the range by milliseconds and not the record, so a
    disagreement is measured again, up to three times, before it fails."""
    for _attempt in range(3):
        timing.reset()
        _out, events = _profiled(PATHS[path], _world())
        summ = timing.summary()
        bad = _disagreements(events, summ)
        if not bad:
            break
    assert not bad, bad
    for name, s in summ.items():
        assert 0 <= s["self_ms"] <= s["host_ms"] + 1e-9
        assert 0 <= s["wait_ms"] <= s["host_ms"] + 1e-9
        if name in WAITS:
            assert s["waits"] == s["count"]
            assert s["wait_ms"] == pytest.approx(s["host_ms"])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_results_bit_identical_with_profiler_on_and_off(path):
    w = _world()
    off = PATHS[path](w)
    on, _events = _profiled(PATHS[path], w)
    _same(off, on)
    assert timing.records()


def test_summary_self_and_wait_arithmetic():
    """Self time is a span's own less its children's; a wait counts in
    itself and in every span around it, once, even around another wait."""
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("outer"):
            with timing.span("inner"):
                with timing.wait("inner.wait"):
                    with timing.wait("inner.wait.nested"):
                        time.sleep(0.002)
            time.sleep(0.001)
    s = timing.summary()
    recs = {r.name: r for r in timing.records()}

    def ms(n):
        return (recs[n].end_ns - recs[n].start_ns) / 1e6
    assert s["outer"]["self_ms"] == pytest.approx(ms("outer") - ms("inner"))
    assert s["inner"]["self_ms"] == pytest.approx(
        ms("inner") - ms("inner.wait"))
    for n in ("outer", "inner", "inner.wait"):
        assert s[n]["waits"] == 1
        assert s[n]["wait_ms"] == pytest.approx(ms("inner.wait"))
    assert s["inner.wait.nested"]["waits"] == 0
    assert ms("outer") >= 3.0 - 1e-3


def test_parent_stacks_are_per_thread(monkeypatch):
    """Spans opened in two threads at once nest within their own thread
    only (the profiler's switch is forced on: it records the thread that
    started it)."""
    monkeypatch.setattr(timing, "_profiling", lambda: True)
    go = threading.Barrier(2, timeout=10)

    def work(tag):
        with timing.span(f"{tag}.outer"):
            go.wait()
            with timing.span(f"{tag}.inner"):
                go.wait()
    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    recs = {r.name: r for r in timing.records()}
    for tag in "ab":
        outer, inner = recs[f"{tag}.outer"], recs[f"{tag}.inner"]
        assert inner.parent == outer.id and outer.parent is None
        assert inner.root == outer.root == outer.id
        assert inner.thread == outer.thread
    assert recs["a.outer"].thread != recs["b.outer"].thread


def test_stage_timer_logs_its_line_and_spans_its_stage(caplog):
    with caplog.at_level(logging.DEBUG, logger="sylph"):
        with timing.stage_timer("load/sketch sample", detail="a.fq"):
            pass
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.stage_timer("process sample", detail="a.fq",
                                    items=4):
                pass
    lines = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("[timing] load/sketch sample a.fq: ")
               for m in lines)
    assert any(m.startswith("[timing] process sample a.fq: ") and
               "items/s" in m for m in lines)
    assert [r.name for r in timing.records()] == ["process sample"]


def test_maybe_profile_logs_the_summary(tmp_path, caplog):
    w = _world()
    with caplog.at_level(logging.INFO, logger="sylph"):
        with timing.maybe_profile(str(tmp_path)):
            _seed(w)
    lines = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Wrote profiler trace to ") for m in lines)
    assert any(m.startswith("[span] seed: 1 x, host ") for m in lines)
    assert len(list(tmp_path.iterdir())) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_host_sync_on_the_card_is_inside_a_wait(cuda, path):
    """One sample of each path on the card with sync debugging on: every
    synchronizing call warns inside a recorded wait, and every wait holds
    at least one such call."""
    w = _world("cuda")
    fn = PATHS[path]
    fn(w)                               # builds, warms up
    torch.cuda.synchronize()
    seen, inside = [], [False]

    def hook(message, *args, **kwargs):
        # only the path's own calls: switching the mode on may warn itself
        if inside[0] and "synchronizing" in str(message):
            seen.append((threading.get_ident(), time.perf_counter_ns(),
                         "".join(traceback.format_stack(limit=6)[:-1])))
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                inside[0] = True
                fn(w)
            finally:
                inside[0] = False
                torch.cuda.set_sync_debug_mode("default")
    waits = [r for r in timing.records() if r.wait]
    outside = [where for th, t, where in seen if not any(
        r.thread == th and r.start_ns <= t <= r.end_ns for r in waits)]
    empty = [r.name for r in waits if not any(
        r.thread == th and r.start_ns <= t <= r.end_ns for th, t, _ in seen)]
    assert not outside, (f"{len(outside)} syncs outside a wait in {path}:\n"
                         + "\n".join(outside))
    assert not empty, f"waits with no sync in {path}: {empty}"
    assert len(seen) >= len(waits)
