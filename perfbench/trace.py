"""Spans around the harness's calls into the port, and the reading of a
torch.profiler trace into what the per-layer metrics need.

A span is a ``torch.profiler.record_function`` range named ``pb.<name>``,
opened only in a traced window (``Spans(on=True)``); the profiler also
draws it on the device timeline, where it is left out. The profiler links
each device activity (kernel, copy, set) to the CPU op that issued it;
``TraceView`` gives each activity's time to the innermost span around that
op, and finds the device's busy time, its idle gaps labelled with what the
host was doing, and the time of each kernel by name.
"""

import bisect
import contextlib

import torch

PREFIX = "pb."


class Spans:
    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


class TraceView:
    """What one profiled window shows; times in seconds."""

    def __init__(self, events):
        spans, ops, dev = [], [], []
        for e in events:
            r = (e.time_range.start, e.time_range.end)
            if e.name.startswith(PREFIX):
                # a span; its copy on the device timeline is no activity
                if not _is_device(e):
                    spans.append((*r, e.name[len(PREFIX):]))
            elif _is_device(e):
                dev.append((*r, e.name))
            else:
                ops.append((*r, e.name))
        spans.sort()
        ops.sort()
        self._spans, self._starts = spans, [s[0] for s in spans]
        self._ops, self._op_starts = ops, [o[0] for o in ops]
        # device time a span issued: each frontend op's linked activities
        self.span_device_s = {}
        for e in events:
            if _is_device(e) or not e.kernels:
                continue
            name = self.span_at(e.time_range.start) or "other"
            self.span_device_s[name] = self.span_device_s.get(name, 0.0) \
                + sum(k.duration for k in e.kernels
                      if not k.name.startswith(PREFIX)) / 1e6
        if spans:
            w0, w1 = spans[0][0], max(s[1] for s in spans)
        else:
            w0 = w1 = 0.0
        self.window_s = (w1 - w0) / 1e6
        self.kernels = {}
        for s, e, name in dev:
            t, n = self.kernels.get(name, (0.0, 0))
            self.kernels[name] = (t + (e - s) / 1e6, n + 1)
        busy, gaps = 0.0, []
        cur0 = cur1 = w0
        for s, e, _name in sorted(dev):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if s > cur1:
                busy += cur1 - cur0
                gaps.append((cur1, s))
                cur0 = s
            cur1 = max(cur1, e)
        busy += cur1 - cur0
        if w1 > cur1:
            gaps.append((cur1, w1))
        self.busy_s = busy / 1e6
        self.idle_by_host = {}
        for g0, g1 in gaps:
            label = self.host_at(g0)
            self.idle_by_host[label] = self.idle_by_host.get(label, 0.0) \
                + (g1 - g0) / 1e6

    def span_at(self, t: float):
        """The innermost span around time t, or None."""
        i = bisect.bisect_right(self._starts, t)
        while i > 0:
            i -= 1
            s, e, name = self._spans[i]
            if s <= t <= e:
                return name
        return None

    def host_at(self, t: float, look: int = 256) -> str:
        """What the host was doing at time t: the span, and the innermost
        CPU op then running."""
        span = self.span_at(t) or "between samples"
        i = bisect.bisect_right(self._op_starts, t)
        for j in range(i - 1, max(-1, i - 1 - look), -1):
            s, e, name = self._ops[j]
            if s <= t <= e:
                return f"{span}: {name}"
        return span

    def kernel(self, fragment: str):
        """(seconds, launches shown) of the device activities whose name
        holds ``fragment``."""
        t = n = 0
        for name, (s, c) in self.kernels.items():
            if fragment in name:
                t, n = t + s, n + c
        return t, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], s] for n, (s, _c) in ops],
                "idle_gaps": [[n[:200], s] for n, s in gaps]}


def per_sample_ms(ctx, span: str):
    """Device ms a traced sample that the activities issued inside
    ``span`` took, or None where the span issued none."""
    t = ctx.trace.span_device_s.get(span) if ctx.trace else None
    return t * 1e3 / ctx.traced_samples if t else None
