"""Stage timing and profiler traces.

Per-stage wall-clock and throughput on the standard `sylph` logger at
DEBUG (`--debug`), so default runs stay quiet; ``maybe_profile`` writes a
torch.profiler trace of a block (`--profile-trace DIR`).
"""

import contextlib
import logging
import os
import time

log = logging.getLogger("sylph")


@contextlib.contextmanager
def stage_timer(stage: str, bases: int = 0, items: int = 0):
    """Log `stage took X s [Y Gbp/s | Z items/s]` at DEBUG on exit."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        extra = ""
        if bases and dt > 0:
            extra = f" ({bases / dt / 1e9:.3f} Gbp/s)"
        elif items and dt > 0:
            extra = f" ({items / dt:.1f} items/s)"
        log.debug("[timing] %s: %.3f s%s", stage, dt, extra)


class PhaseAcc:
    """Thread-safe per-phase busy-time accumulator for pipelined stages.

    Used by the streaming ingest (at DEBUG) to attribute wall time across
    the decode / parse / seed / fingerprint / fold threads: per-phase BUSY
    seconds summed over threads, not wall time, so they show which stage is
    the pipeline's critical path."""

    def __init__(self):
        import threading
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
    never ends well without one."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_"
                        f"{int(time.time() * 1000)}.json")
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    if not os.path.getsize(path):
        raise RuntimeError(f"the profiler wrote an empty trace to {path}")
    log.info("Wrote profiler trace to %s", path)
