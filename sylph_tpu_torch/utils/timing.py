"""Stage timing, spans, host waits and profiler traces.

Per-stage wall-clock and throughput on the standard `sylph` logger at
DEBUG (`--debug`), so default runs stay quiet; ``maybe_profile`` writes a
torch.profiler trace of a block (`--profile-trace DIR`).

``span(name)`` marks a layer boundary. While no torch.profiler records in
the calling thread it returns one shared no-op context and records nothing.
While one records, it opens a CPU-only profiler range ``sylph.<name>``
(``_RecordFunctionFast``: not a user annotation, so the profiler draws no
copy of it on the device timeline) and keeps a ``Record`` in memory: its
name, the enclosing span on the same thread, the root span's id (one id
for the spans of one top-level call) and its host start and end
(``time.perf_counter_ns``). ``wait(name)`` is a span whose record counts as
a host wait: it wraps a statement that blocks the host on the device.
``records()`` and ``summary()`` read what was kept, ``reset()`` clears it.
"""

import contextlib
import functools
import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import torch

log = logging.getLogger("sylph")

_Range = torch._C._profiler._RecordFunctionFast
_profiling = torch._C._autograd._profiler_enabled

PREFIX = "sylph."
# the oldest records go past this many (a long-lived process profiled
# again and again between resets)
MAX_RECORDS = 1 << 18


class Record(NamedTuple):
    id: int
    name: str
    parent: Optional[int]   # id of the enclosing span on the same thread
    root: int               # id of the outermost span around it (or its own)
    thread: int             # threading.get_ident() of the thread
    start_ns: int           # time.perf_counter_ns()
    end_ns: int
    wait: bool              # a host wait on the device


_RECORDS = deque(maxlen=MAX_RECORDS)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_NOOP = contextlib.nullcontext()


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class _Span:
    __slots__ = ("name", "wait", "id", "parent", "root", "start", "_range")

    def __init__(self, name: str, wait: bool):
        self.name, self.wait = name, wait

    def __enter__(self):
        stack = _stack()
        self.id = next(_IDS)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self._range = _Range(PREFIX + self.name)
        self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _stack().pop()
        _RECORDS.append(Record(self.id, self.name, self.parent, self.root,
                               threading.get_ident(), self.start, end,
                               self.wait))
        return False


def span(name: str):
    """A layer's span (see the module docstring): the shared no-op while
    no profiler records in this thread."""
    if not _profiling():
        return _NOOP
    return _Span(name, False)


def wait(name: str):
    """A span around a statement that blocks the host on the device."""
    if not _profiling():
        return _NOOP
    return _Span(name, True)


def spanned(name: str):
    """A decorator: the whole call inside ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return deco


def records() -> list:
    """Every kept Record, oldest first (a span's record is kept when it
    ends, so children come before their parent)."""
    return list(_RECORDS)


def reset() -> None:
    _RECORDS.clear()


def summary() -> dict:
    """{span name: {count, host_ms, self_ms, wait_ms, waits}} over the kept
    records: host ms inside the spans, self ms (less what their child spans
    cover), ms and number of the waits inside them (a wait counts inside
    itself; one inside another wait is not counted again)."""
    recs = records()
    by_id = {r.id: r for r in recs}
    child_ns, wait_ns, waits = {}, {}, {}
    for r in recs:
        d = r.end_ns - r.start_ns
        if r.parent is not None:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + d
        if not r.wait:
            continue
        chain, p = [r.id], r.parent
        while p is not None and p in by_id and not by_id[p].wait:
            chain.append(p)
            p = by_id[p].parent
        if p is not None and p in by_id:
            continue                # inside a wait that counts already
        for i in chain:
            wait_ns[i] = wait_ns.get(i, 0) + d
            waits[i] = waits.get(i, 0) + 1
    out = {}
    for r in recs:
        d = r.end_ns - r.start_ns
        s = out.setdefault(r.name, dict(count=0, host_ms=0.0, self_ms=0.0,
                                        wait_ms=0.0, waits=0))
        s["count"] += 1
        s["host_ms"] += d / 1e6
        s["self_ms"] += (d - child_ns.get(r.id, 0)) / 1e6
        s["wait_ms"] += wait_ns.get(r.id, 0) / 1e6
        s["waits"] += waits.get(r.id, 0)
    return out


@contextlib.contextmanager
def stage_timer(stage: str, bases: int = 0, items: int = 0,
                detail: str = ""):
    """Log `stage [detail] took X s [Y Gbp/s | Z items/s]` at DEBUG on exit,
    inside a span named ``stage`` (``detail``, a file name or a count,
    stays in the log line)."""
    t0 = time.perf_counter()
    try:
        with span(stage):
            yield
    finally:
        dt = time.perf_counter() - t0
        extra = ""
        if bases and dt > 0:
            extra = f" ({bases / dt / 1e9:.3f} Gbp/s)"
        elif items and dt > 0:
            extra = f" ({items / dt:.1f} items/s)"
        log.debug("[timing] %s: %.3f s%s",
                  f"{stage} {detail}" if detail else stage, dt, extra)


class PhaseAcc:
    """Thread-safe per-phase busy-time accumulator for pipelined stages.

    Used by the streaming ingest (at DEBUG) to attribute wall time across
    the decode / parse / seed / fingerprint / fold threads: per-phase BUSY
    seconds summed over threads, not wall time, so they show which stage is
    the pipeline's critical path."""

    def __init__(self):
        self._t = {}
        self._lock = threading.Lock()

    def add(self, name: str, dt: float):
        with self._lock:
            self._t[name] = self._t.get(name, 0.0) + dt

    def log_summary(self, label: str, wall: float):
        with self._lock:
            busy = dict(self._t)
        parts = " ".join(f"{k}={v:.2f}" for k, v in sorted(busy.items()))
        log.debug("[ingest] %s wall=%.2f s | busy: %s", label, wall, parts,
                  extra={"ingest_busy": busy, "ingest_wall": wall})


@contextlib.contextmanager
def maybe_profile(trace_dir):
    """A torch.profiler trace of the block (CPU activities, and CUDA ones
    where there is a GPU) written to ``trace_dir`` as a Chrome trace file
    (``trace_<pid>_<ms>.json``), when set; a no-op otherwise. Unlike
    sylph_tpu/utils/timing.py:63, which warns and goes on, a trace that
    cannot start or cannot be written raises: a run that asked for a trace
    never ends well without one. After the trace is written, ``summary()``
    of the block's spans is logged at INFO, one line a span name."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_"
                        f"{int(time.time() * 1000)}.json")
    reset()
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    if not os.path.getsize(path):
        raise RuntimeError(f"the profiler wrote an empty trace to {path}")
    log.info("Wrote profiler trace to %s", path)
    for name, s in sorted(summary().items(),
                          key=lambda kv: -kv[1]["host_ms"]):
        log.info("[span] %s: %d x, host %.3f ms, self %.3f ms, wait %.3f ms "
                 "(%d waits)", name, s["count"], s["host_ms"], s["self_ms"],
                 s["wait_ms"], s["waits"])
