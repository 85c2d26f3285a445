"""Batched coverage statistics on the device: histogram -> ANI/lambda per
genome (counterpart of sylph_tpu/tpu/stats.py).

An f32 re-expression of the host statistics chain (stats/contain_stats.py;
sylph src/contain.rs:654-847, src/inference.rs:207-242) computed for all
genomes at once from the [G, H] multiplicity histograms: naive ANI, median,
Poisson outlier cut, ratio-lambda, lambda-adjusted ANI. The host chain stays
the f64 oracle of the TSVs. The Poisson cut tests the lower regularized
gamma P(v+1, median) > 1 - CUTOFF_PVALUE, which equals the reference's
``cdf < CUTOFF_PVALUE`` but stays representable in f32. Plain torch on
whatever device the histogram lies on (XLA, not a Pallas kernel, in the JAX
package); f32 ``pow``, ``exp`` and ``gammainc`` differ from XLA's in the
last bits.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..constants import (CUTOFF_PVALUE, MAX_MEDIAN_FOR_MEAN_FINAL_EST,
                         MEDIAN_ANI_THRESHOLD, SAMPLE_SIZE_CUTOFF)
from ..utils.timing import spanned

_TAIL_P = float(np.float32(np.float64(1.0) - np.float64(CUTOFF_PVALUE)))


class GenomeStats(NamedTuple):
    """Per-genome results, each shaped like the histogram without its last
    axis ([G], or [S, G] for a leading sample axis)."""
    naive_ani: torch.Tensor     # f32
    final_ani: torch.Tensor     # f32 (lambda-adjusted where available)
    final_cov: torch.Tensor     # f32 effective coverage
    lam: torch.Tensor           # f32 ratio-lambda (garbage where ~lam_valid)
    lam_valid: torch.Tensor     # bool
    median_cov: torch.Tensor    # f32
    mean_cov: torch.Tensor      # f32 (>=1 mean, the TSV's Mean_cov_geq1)
    contained: torch.Tensor     # i32: pre-cut containment count
    n_inliers: torch.Tensor     # i32: post-Poisson-cut count
    valid: torch.Tensor         # bool: passes min_ani & size gates


@spanned("stats")
def stats_from_histograms(hist: torch.Tensor, n_kmers: torch.Tensor, *,
                          k: int, min_ani: float,
                          min_count_correct: float = 3.0,
                          min_number_kmers: float = 50.0) -> GenomeStats:
    """hist: [..., G, H] integer multiplicity histograms (bucket 0 = not
    contained); n_kmers: [G] genome sketch sizes."""
    H = hist.shape[-1]
    f32 = torch.float32
    dev = hist.device
    hist = hist.to(torch.int64)
    n_kmers = n_kmers.to(dev).to(torch.int64)
    n_kmers_f = n_kmers.to(f32)
    mult = torch.arange(H, dtype=f32, device=dev)          # bucket -> value

    contained = hist[..., 1:].sum(dim=-1)
    contained_f = contained.to(f32)
    inv_k = float(np.float32(1.0 / k))
    naive_ani = torch.pow(contained_f / n_kmers_f.clamp(min=1.0), inv_k)

    # median = covs_sorted[contained // 2] via the histogram's cumsum
    cum = torch.cumsum(hist[..., 1:], dim=-1)
    target = (contained.clamp(min=1) // 2).unsqueeze(-1)
    median = (torch.argmax((cum > target).to(torch.int32), dim=-1)
              + 1).to(f32)

    # Poisson outlier cut (src/contain.rs:664-675), monotone in v, applied
    # only when median < 30
    lower_p = torch.special.gammainc(mult + 1.0, median.unsqueeze(-1))
    inlier = torch.where(median.unsqueeze(-1) < 30.0, lower_p > _TAIL_P,
                         True)
    inlier[..., 0] = True
    hist_in = torch.where(inlier, hist, 0)

    vals = hist_in[..., 1:]
    n_inliers = vals.sum(dim=-1)
    n_full_f = (n_kmers - contained + n_inliers).to(f32).clamp(min=1.0)
    inlier_sum = (vals.to(f32) * mult[1:]).sum(dim=-1)
    geq1_mean = inlier_sum / contained_f.clamp(min=1.0)

    # ratio-lambda on the inlier histogram (src/inference.rs:207-242): modal
    # nonzero multiplicity m (ties -> larger value), lambda =
    # hist[m+1]/hist[m] * (m+1)
    m_val = H - 1 - torch.argmax(torch.flip(vals, dims=[-1]), dim=-1)
    cnt_m = torch.gather(hist_in, -1, m_val.unsqueeze(-1)).squeeze(-1)
    mp1 = (m_val + 1).clamp(max=H - 1)
    cnt_mp1 = torch.gather(hist_in, -1, mp1.unsqueeze(-1)).squeeze(-1)
    cnt_mp1 = torch.where(m_val + 1 <= H - 1, cnt_mp1, 0)
    n_nonzero_vals = (vals > 0).sum(dim=-1)
    lam = (cnt_mp1.to(f32) / cnt_m.to(f32).clamp(min=1.0)
           * (m_val.to(f32) + 1.0))
    lam_ok = ((n_nonzero_vals > 1)
              & (n_inliers >= SAMPLE_SIZE_CUTOFF)
              & (cnt_mp1.to(f32) >= min_count_correct)
              & (cnt_m.to(f32) >= min_count_correct)
              & (median <= MEDIAN_ANI_THRESHOLD))

    # final coverage estimate (src/contain.rs:715-728)
    final_cov = torch.where(
        lam_ok, lam,
        torch.where(median < MAX_MEDIAN_FOR_MEAN_FINAL_EST, geq1_mean,
                    median))

    # lambda-adjusted ANI (src/contain.rs:817-847)
    adj_index = (n_inliers.to(f32)
                 / (1.0 - torch.exp(-lam)).clamp(min=1e-30) / n_full_f)
    adj_ani = torch.pow(adj_index, inv_k)
    adj_ok = lam_ok & torch.isfinite(adj_ani) & (adj_ani >= 0.0)
    final_ani = torch.where(adj_ok, adj_ani, naive_ani)

    valid = ((contained > 0)
             & (n_kmers_f >= min_number_kmers)
             & (final_ani >= min_ani))

    return GenomeStats(
        naive_ani=naive_ani, final_ani=final_ani, final_cov=final_cov,
        lam=lam, lam_valid=lam_ok, median_cov=median, mean_cov=geq1_mean,
        contained=contained.to(torch.int32),
        n_inliers=n_inliers.to(torch.int32), valid=valid)
