"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (perfbench/reference/), number by number, each
held to the limit the configuration's ``limits`` give it.

  unanswered      window samples whose result never reached the host
  seed_mismatch   kept runs: distinct hashes whose multiplicity in the
                  port's seeding output differs from the reference sketch
  hist_mismatch   kept runs: (genome, multiplicity) bins, 1 and up, of the
                  port's histograms unlike the reference join's
  count_mismatch  every run: genomes whose contained or inlier count or
                  lambda validity differs from the reference statistics
  stat_gap        every run: the largest relative gap of a float statistic
                  (naive and final ANI, coverage, lambda where valid,
                  median, mean) of a genome the reference finds contained
"""

import numpy as np
import torch

from .gen.hashing import INT64_MIN
from .reference.sketch import multiset
from .reference.stats import COUNTS, FLOATS

NAMES = ("unanswered", "seed_mismatch", "hist_mismatch", "count_mismatch",
         "stat_gap")


def multiset_mismatch(stream: torch.Tensor, ref_keys, ref_counts) -> int:
    """Distinct hashes whose count differs between the port's raw seeding
    output (any shape, -1 pads) and the reference sketch."""
    pk, pc = multiset(stream.reshape(-1))
    pk, rk = pk ^ INT64_MIN, ref_keys ^ INT64_MIN    # searched in u64 order
    keys = torch.unique(torch.cat([pk, rk]))

    def count(k, c):
        if k.numel() == 0:
            return torch.zeros_like(keys)
        pos = torch.clamp(torch.searchsorted(k, keys), max=k.numel() - 1)
        return torch.where(k[pos] == keys, c[pos], 0)
    return int((count(pk, pc) != count(rk, ref_counts)).sum())


def stats_mismatch(port: dict, ref: dict):
    """(genomes with a count unlike the reference's, largest relative gap
    of a float statistic) of one run's host results."""
    live = (ref["contained"] > 0) | (port["contained"] > 0)
    differ = np.zeros(live.shape, bool)
    for f in COUNTS:
        differ |= port[f] != ref[f]
    counted = int((differ & live).sum())
    ok = ref["contained"] > 0
    gap = 0.0
    for f in FLOATS:
        sel = ok & (ref["lam_valid"] == 1) if f == "lam" else ok
        r = ref[f][sel].astype(np.float64)
        p = port[f][sel].astype(np.float64)
        if r.size == 0:
            continue
        g = np.abs(p - r) / np.maximum(np.abs(r), 1e-300)
        g = np.where(np.isnan(g), np.inf, g)
        gap = max(gap, float(g.max()))
    return counted, gap


def compare(runs, ref_stats, ref_sketches, ref_hists) -> dict:
    """The numbers over every run of the window. ``runs``: (pool sample,
    Result or None); ``ref_stats``: per pool sample {field: host array};
    ``ref_sketches``/``ref_hists``: per pool sample, on the device."""
    out = dict.fromkeys(NAMES, 0)
    out["stat_gap"] = 0.0
    wrong = 0
    for s, res in runs:
        if res is None:
            out["unanswered"] += 1
            continue
        counted, gap = stats_mismatch(res.stats, ref_stats[s])
        bad = counted > 0
        out["count_mismatch"] += counted
        out["stat_gap"] = max(out["stat_gap"], gap)
        if res.stream is not None:
            n = multiset_mismatch(res.stream, *ref_sketches[s])
            out["seed_mismatch"] += n
            bad |= n > 0
        if res.hist is not None:
            n = int((res.hist[:, 1:].to(ref_hists[s].device)
                     != ref_hists[s][:, 1:]).sum())
            out["hist_mismatch"] += n
            bad |= n > 0
        wrong += bad
    out["wrong_runs"] = wrong
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[n] <= limits[n] for n in NAMES)
