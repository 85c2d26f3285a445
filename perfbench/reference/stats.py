"""The plain reference of sylph's per-genome statistics, from a genome's
multiplicity histogram (sylph src/contain.rs:624-847, src/inference.rs:
207-242; constants src/constants.rs:1-17), computed in ``dtype``: float64
for the reference, a lower precision for the control.

For a genome of n sketch k-mers, c of them contained with multiplicities
covs (sorted ascending):
  naive ANI   (c / n)^(1/k)
  median      covs[c // 2]
  inliers     when median < 30, the covs whose Poisson(median) CDF is
              below 0.9999999999; all of them otherwise
  mean        the inliers' sum over c (the TSV's Mean_cov_geq1)
  lambda      at median <= 2: the inliers' modal value m (ties to the
              larger), lambda = count[m+1] / count[m] * (m+1), valid iff
              the inliers hold two values or more, 25 or more k-mers, and
              count[m] and count[m+1] are both 3 or more
  coverage    lambda where valid, else the mean below a median of 15, else
              the median
  final ANI   (n_inliers / (1 - e^-lambda) / (n - c + n_inliers))^(1/k)
              where lambda is valid and that is a finite number >= 0, else
              the naive ANI
The histogram's last bin holds every multiplicity of H - 1 or more.
"""

import torch

CUTOFF_PVALUE = 0.9999999999
SAMPLE_SIZE_CUTOFF = 25
MEDIAN_ANI_THRESHOLD = 2.0
MAX_MEDIAN_FOR_MEAN_FINAL_EST = 15.0
MIN_COUNT_CORRECT = 3

FLOATS = ("naive_ani", "final_ani", "final_cov", "lam", "median_cov",
          "mean_cov")
COUNTS = ("contained", "n_inliers", "lam_valid")


def genome_stats(hist: torch.Tensor, n_kmers: torch.Tensor, *, k: int,
                 dtype=torch.float64) -> dict:
    """hist [..., G, H] integer histograms, n_kmers [G] -> {field: [..., G]}
    (FLOATS in ``dtype``, COUNTS int64). Fields of a genome with nothing
    contained are not meaningful."""
    H = hist.shape[-1]
    dev = hist.device
    h = hist[..., 1:].to(torch.int64)
    vals = torch.arange(1, H, device=dev)
    n = n_kmers.to(torch.int64)
    contained = h.sum(-1)
    f = lambda x: x.to(dtype)  # noqa: E731
    inv_k = f(torch.tensor(1.0 / k, dtype=torch.float64))
    naive = torch.pow(f(contained) / f(n), inv_k)

    cum = torch.cumsum(h, -1)
    mid = torch.argmax((cum > (contained // 2)[..., None]).to(torch.int8),
                       -1)
    median = mid + 1
    # the Poisson CDF at v is the regularized upper gamma Q(v + 1, median)
    cdf_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    cdf = torch.special.gammaincc(vals.to(cdf_dtype) + 1,
                                  median[..., None].to(cdf_dtype))
    inlier = torch.where(median[..., None] < 30, cdf < CUTOFF_PVALUE, True)
    hin = torch.where(inlier, h, 0)
    n_in = hin.sum(-1)
    mean = f((hin * vals).sum(-1)) / f(contained)

    top = H - 2                                   # index of the last bin
    m_idx = top - torch.argmax(torch.flip(hin, dims=[-1]), -1)
    cnt_m = torch.gather(hin, -1, m_idx[..., None])[..., 0]
    nxt = torch.clamp(m_idx + 1, max=top)
    cnt_p1 = torch.where(m_idx + 1 <= top,
                         torch.gather(hin, -1, nxt[..., None])[..., 0], 0)
    lam = f(cnt_p1) / f(cnt_m) * f(m_idx + 2)
    lam_valid = (((hin > 0).sum(-1) > 1) & (n_in >= SAMPLE_SIZE_CUTOFF)
                 & (cnt_p1 >= MIN_COUNT_CORRECT)
                 & (cnt_m >= MIN_COUNT_CORRECT)
                 & (median <= MEDIAN_ANI_THRESHOLD))
    cov = torch.where(lam_valid, lam,
                      torch.where(median < MAX_MEDIAN_FOR_MEAN_FINAL_EST,
                                  mean, f(median)))
    n_full = n - contained + n_in
    adj = torch.pow(f(n_in) / (1 - torch.exp(-lam)) / f(n_full), inv_k)
    adj_ok = lam_valid & torch.isfinite(adj) & (adj >= 0)
    return dict(naive_ani=naive, final_ani=torch.where(adj_ok, adj, naive),
                final_cov=cov, lam=lam, median_cov=f(median), mean_cov=mean,
                contained=contained, n_inliers=n_in,
                lam_valid=lam_valid.to(torch.int64))
