"""The share of the measured window's samples whose grange sweep failed
its capacity probe and was swept again (the cell capacity that
``GRangeEngine.plan_stream`` sizes from the sample's mean falls short of
a cell's keys)."""


def read(ctx):
    res = [r for r in ctx.window_results if r is not None]
    if not res:
        return None
    return 100.0 * sum(r.retried for r in res) / len(res)
