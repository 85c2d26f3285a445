"""The share of the measured window's samples that the bucket regime's
engine ran again at a larger sample capacity (its ``refills`` counter
moved: a fill dropped sample entries for want of lanes, and the probe
said so)."""


def read(ctx):
    res = [r for r in ctx.window_results if r is not None]
    if not res:
        return None
    return 100.0 * sum(r.retried for r in res) / len(res)
