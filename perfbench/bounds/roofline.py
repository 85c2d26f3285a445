"""A kernel's share of its roofline over a traced window: the least time
its launches' work needs (bounds/work.py, arith.py) over the profiler's
time of those launches."""

from .arith import bound_s


def roofline_pct(ctx, fragment: str, launch_key: str, work_key: str,
                 rivals=()):
    """``fragment``: a piece of the kernel's symbol; ``launch_key``: its
    count in the port's launch counters; ``rivals``: counters of other
    launches of the same symbol, which must be 0. Where the profiler shows
    fewer launches than were made, the shown ones' mean time stands for
    the rest. None where nothing was shown or the launches are mixed."""
    if ctx.trace is None or any(ctx.trace_launches.get(r) for r in rivals):
        return None
    t, shown = ctx.trace.kernel(fragment)
    made = ctx.trace_launches.get(launch_key, 0)
    launches = ctx.work.get(work_key, [])
    if not (t and shown and made and launches):
        return None
    need = sum(bound_s(b, c)[0] for b, c in launches)
    return 100.0 * need / (t * made / shown)
