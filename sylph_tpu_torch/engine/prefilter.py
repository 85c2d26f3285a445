"""Batched survivor prefilter: vectorized pass-1 statistics for all genomes.

At database scale (10^5 genomes) the per-genome Python statistics loop
(get_stats per genome, sylph src/contain.rs:284-292) is dominated by
non-matching genomes — almost every pair computes a handful of numbers and
returns None. This module replicates the decision chain of
``stats.contain_stats.coverage_stats`` (spec: src/contain.rs:654-764 +
src/inference.rs:207-242) as ONE vectorized numpy pass over per-genome
coverage histograms, and returns the indices of genomes that might pass the
ANI floor. The exact scalar path (including bootstrap CIs) then runs only on
those candidates, so TSV output stays byte-identical:

  - the inlier (Poisson outlier cut) set is reproduced EXACTLY — the cut is
    a function of (median, present multiplicities) only, evaluated with the
    same Cephes-style CDF, including the reference's break-at-first-
    failing-present-value semantics;
  - lambda and the adjusted ANI use the same f64 formulas; a small margin
    on the ANI floor absorbs ulp-level divergence between vectorized and
    scalar transcendentals, so the candidate set is a superset of the true
    survivor set.

Histograms clamp multiplicities at H-1 = 63. This loses nothing: the
lambda path requires median <= 2 (inlier multiplicities there are bounded
far below 63 by the Poisson cut), and every other path decides on
naive ANI, which depends only on the containment count.
"""

from typing import Iterator, Optional, Tuple

import numpy as np

from ..constants import (CUTOFF_PVALUE, MEDIAN_ANI_THRESHOLD,
                         SAMPLE_SIZE_CUTOFF)
from ..stats.gammainc import poisson_cdf

_H = 64                 # histogram width (multiplicities clamp at _H - 1)
_ANI_MARGIN = 1e-9      # ulp guard on the ANI floor comparison
_HOST_CHUNK = 1 << 25   # index k-mers per host searchsorted chunk


def genome_hists(counts_chunks: Iterator[Tuple[np.ndarray, np.ndarray]],
                 n_genomes: int) -> np.ndarray:
    """[G, H] multiplicity histograms (count >= 1 only) from (counts, gids)
    chunks covering the flattened genome index (the host engine's)."""
    flat = np.zeros(n_genomes * _H, dtype=np.int64)
    for counts, gids in counts_chunks:
        m = (counts > 0) & (gids >= 0) & (gids < n_genomes)
        if not m.any():
            continue
        seg = (gids[m].astype(np.int64) * _H
               + np.minimum(counts[m].astype(np.int64), _H - 1))
        flat += np.bincount(seg, minlength=n_genomes * _H)
    return flat.reshape(n_genomes, _H)


def host_counts_chunks(genome_sketches, sample):
    """Chunked (counts, gids) stream via batched searchsorted (the host
    engine): one big probe replaces 10^5 per-genome searchsorted calls;
    memory stays bounded at about _HOST_CHUNK k-mers a chunk."""
    sk, sc = sample.sorted_view()
    batch_kmers, batch_gids, acc = [], [], 0
    for gi, g in enumerate(genome_sketches):
        kk = g.genome_kmers
        if kk.size == 0:
            continue
        batch_kmers.append(kk)
        batch_gids.append(np.full(kk.size, gi, np.int64))
        acc += kk.size
        if acc >= _HOST_CHUNK:
            yield _probe(sk, sc, batch_kmers, batch_gids)
            batch_kmers, batch_gids, acc = [], [], 0
    if batch_kmers:
        yield _probe(sk, sc, batch_kmers, batch_gids)


def _probe(sk, sc, batch_kmers, batch_gids):
    g = np.concatenate(batch_kmers)
    gids = np.concatenate(batch_gids)
    if sk.size == 0:
        return np.zeros(g.size, np.int64), gids
    idx = np.searchsorted(sk, g)
    idxc = np.minimum(idx, sk.size - 1)
    found = (sk[idxc] == g) & (idx < sk.size)
    counts = np.where(found, sc[idxc], 0)
    return counts.astype(np.int64), gids


def candidate_mask(hist: np.ndarray, n_kmers: np.ndarray, *, k: int,
                   min_ani: float, min_number_kmers: float,
                   min_count_correct: float, no_adj: bool) -> np.ndarray:
    """[G] bool: True iff the genome MIGHT pass the ANI floor.

    Mirrors coverage_stats decision-by-decision; every comparison against
    min_ani carries a margin so this is a superset of the scalar result.
    """
    G = hist.shape[0]
    vals = np.arange(_H, dtype=np.int64)
    contained = hist[:, 1:].sum(axis=1)
    n_kmers = n_kmers.astype(np.int64)
    ok_size = (n_kmers.astype(np.float64) >= min_number_kmers)
    nonzero = contained > 0
    safe_n = np.maximum(n_kmers, 1)
    safe_contained = np.maximum(contained, 1)

    naive_ani = np.power(contained / safe_n.astype(np.float64), 1.0 / k)
    keep = ok_size & nonzero & (naive_ani >= min_ani - _ANI_MARGIN)
    if no_adj:
        return keep

    # median = covs_sorted[contained // 2] (clamped at _H-1; exact when the
    # lambda gate median <= 2 can fire)
    cum = np.cumsum(hist[:, 1:], axis=1)
    median = np.argmax(cum > (safe_contained // 2)[:, None], axis=1) + 1

    lam_rows = np.flatnonzero(ok_size & nonzero & ~keep
                              & (median <= MEDIAN_ANI_THRESHOLD)
                              & (contained >= SAMPLE_SIZE_CUTOFF))
    if lam_rows.size == 0:
        return keep

    h = hist[lam_rows]                             # [R, H]
    med = median[lam_rows].astype(np.float64)      # in {1, 2}

    # Poisson outlier cut with the reference's scan semantics
    # (src/contain.rs:664-675): walk PRESENT values ascending from the
    # median; max_cov = last passing value before the first present failure.
    cdf = np.empty_like(h, dtype=np.float64)
    for m in np.unique(med):
        rows = med == m
        cdf[rows] = [poisson_cdf(float(v), float(m)) for v in vals]
    passes = cdf < CUTOFF_PVALUE
    present = h > 0
    in_scan = vals[None, :] >= med[:, None]
    fail_present = present & ~passes & in_scan
    # first failing present value per row (or _H if none)
    first_fail = np.where(fail_present.any(axis=1),
                          np.argmax(fail_present, axis=1), _H)
    allowed = present & passes & in_scan & (vals[None, :]
                                            < first_fail[:, None])
    has_allowed = allowed.any(axis=1)
    max_cov = np.where(
        has_allowed, (_H - 1) - np.argmax(allowed[:, ::-1], axis=1), -1)
    # values below the median always survive the cut (<= max_cov >= median)
    inlier = vals[None, :] <= np.maximum(max_cov, med.astype(np.int64)
                                         )[:, None]
    h_in = np.where(inlier, h, 0)
    h_in[:, 0] = h[:, 0]

    n_inliers = h_in[:, 1:].sum(axis=1)
    n_full = n_kmers[lam_rows] - contained[lam_rows] + n_inliers

    # ratio lambda (src/inference.rs:207-242) on the inlier histogram with
    # zeros: nz values >= 2 distinct, n_inliers >= 25, modal value m
    # (ties -> larger), both counts >= min_count_correct.
    nz = h_in[:, 1:] > 0
    n_distinct = nz.sum(axis=1)
    best = h_in[:, 1:].max(axis=1)
    # modal value: largest v in 1.._H-1 achieving the max count
    is_best = (h_in[:, 1:] == best[:, None]) & nz
    most_ind = (_H - 1) - np.argmax(is_best[:, ::-1], axis=1)
    mp1 = np.minimum(most_ind + 1, _H - 1)
    cnt_m = np.take_along_axis(h_in, most_ind[:, None], axis=1)[:, 0]
    cnt_mp1 = np.take_along_axis(h_in, mp1[:, None], axis=1)[:, 0]
    cnt_mp1 = np.where(most_ind + 1 <= _H - 1, cnt_mp1, 0)
    lam_ok = ((n_distinct > 1)
              & (n_inliers >= SAMPLE_SIZE_CUTOFF)
              & (cnt_mp1.astype(np.float64) >= min_count_correct)
              & (cnt_m.astype(np.float64) >= min_count_correct))
    with np.errstate(divide="ignore", invalid="ignore"):
        lam = (cnt_mp1.astype(np.float64)
               / np.maximum(cnt_m, 1).astype(np.float64)
               * (most_ind.astype(np.float64) + 1.0))
        # adjusted ANI (src/contain.rs:817-847)
        adj_index = (n_inliers.astype(np.float64)
                     / (1.0 - np.exp(-lam))
                     / np.maximum(n_full, 1).astype(np.float64))
        adj_ani = np.power(adj_index, 1.0 / k)
    adj_pass = lam_ok & np.isfinite(adj_ani) & (adj_ani >= 0.0) \
        & (adj_ani >= min_ani - _ANI_MARGIN)
    keep[lam_rows[adj_pass]] = True
    return keep


_DEV_ANI_MARGIN = 1e-5   # f32 device mask margin (vs 1e-9 for host f64):
#                          pow/exp relative error in f32 is ~1e-7, so the
#                          wider margin keeps the superset property while
#                          still excluding everything not near the floor


def _poisson_cut_vstar(median: int) -> int:
    """Largest multiplicity passing the Poisson outlier cut for a given
    (small) median — host f64, exact Cephes CDF. The cut is monotone in v
    (CDF increasing), so on device it reduces to v <= vstar."""
    v = median
    while v + 1 < _H and poisson_cdf(float(v + 1),
                                     float(median)) < CUTOFF_PVALUE:
        v += 1
    return v


def _f32(x: float) -> float:
    """``x`` rounded to float32 (a scalar compared with f32 tensors)."""
    return float(np.float32(x))


def candidate_mask_device(hist, n_kmers, *, k: int, min_ani: float,
                          min_number_kmers: float,
                          min_count_correct: float, no_adj: bool):
    """Device (torch) twin of candidate_mask: [G] bool on hist's device.

    Same decision chain in f32 with a wider floor margin
    (_DEV_ANI_MARGIN) so it remains a SUPERSET of the host mask; the exact
    f64 statistics then run only on the candidate indices. The Poisson
    outlier cut needs no device CDF: its thresholds for the two possible
    lambda-gate medians are precomputed exactly on the host
    (_poisson_cut_vstar)."""
    import torch

    f32 = torch.float32
    H = _H
    hist = hist.reshape(-1, H).to(torch.int32)
    n_kmers = n_kmers.to(torch.int32)
    vals = torch.arange(H, dtype=torch.int32, device=hist.device)
    contained = hist[:, 1:].sum(dim=1, dtype=torch.int32)
    ok_size = n_kmers.to(f32) >= _f32(min_number_kmers)
    nonzero = contained > 0
    safe_n = torch.clamp(n_kmers, min=1)
    naive = torch.pow(contained.to(f32) / safe_n.to(f32), _f32(1.0 / k))
    floor = _f32(min_ani - _DEV_ANI_MARGIN)
    keep = ok_size & nonzero & (naive >= floor)
    if no_adj:
        return keep

    cum = torch.cumsum(hist[:, 1:], dim=1)
    half = torch.clamp(contained, min=1) // 2
    median = (torch.argmax((cum > half[:, None]).to(torch.int32), dim=1)
              + 1).to(torch.int32)
    gate = (ok_size & nonzero & ~keep
            & (median <= int(MEDIAN_ANI_THRESHOLD))
            & (contained >= SAMPLE_SIZE_CUTOFF))

    vstar = torch.where(median == 1, _poisson_cut_vstar(1),
                        _poisson_cut_vstar(2)).to(torch.int32)
    # inliers: values <= max(vstar, median); zeros column preserved
    inlier = vals[None, :] <= torch.maximum(vstar, median)[:, None]
    h_in = torch.where(inlier, hist, 0)
    h_in[:, 0] = hist[:, 0]

    n_inliers = h_in[:, 1:].sum(dim=1, dtype=torch.int32)
    n_full = n_kmers - contained + n_inliers

    nz = h_in[:, 1:] > 0
    n_distinct = nz.sum(dim=1)
    best = h_in[:, 1:].max(dim=1).values
    is_best = (h_in[:, 1:] == best[:, None]) & nz
    # modal value: LARGEST v achieving the max count (ties -> larger)
    most_ind = (H - 1) - torch.argmax(
        torch.flip(is_best, dims=(1,)).to(torch.int32), dim=1)
    mp1 = torch.clamp(most_ind + 1, max=H - 1)
    cnt_m = torch.gather(h_in, 1, most_ind[:, None])[:, 0]
    cnt_mp1 = torch.gather(h_in, 1, mp1[:, None])[:, 0]
    cnt_mp1 = torch.where(most_ind + 1 <= H - 1, cnt_mp1, 0)
    mcc = _f32(min_count_correct)
    lam_ok = ((n_distinct > 1)
              & (n_inliers >= SAMPLE_SIZE_CUTOFF)
              & (cnt_mp1.to(f32) >= mcc)
              & (cnt_m.to(f32) >= mcc))
    lam = (cnt_mp1.to(f32) / torch.clamp(cnt_m, min=1).to(f32)
           * (most_ind.to(f32) + 1.0))
    adj_index = (n_inliers.to(f32)
                 / (1.0 - torch.exp(-lam))
                 / torch.clamp(n_full, min=1).to(f32))
    adj_ani = torch.pow(torch.clamp(adj_index, min=0.0), _f32(1.0 / k))
    adj_pass = (gate & lam_ok & torch.isfinite(adj_ani)
                & (adj_ani >= floor))
    return keep | adj_pass


def prefilter_candidates(opts, sample, genome_sketches,
                         device_engine=None) -> Optional[np.ndarray]:
    """Candidate genome indices for pass-1, or None when the prefilter
    does not apply (hidden estimators can raise ANI in ways this pass does
    not model, and tiny databases don't need it). The device engine's [G]
    mask is used when it has one (the grange regime on one device in one
    process, sylph_tpu/tpu/grange.py:1525-1540); otherwise its [G, 64]
    histograms, merged over the processes of a group, go through the host
    mask. With no device engine (the host engine, ``--device host``) the
    histograms come from host searchsorted probes (host_counts_chunks)."""
    if opts.estimator != "ratio":
        return None
    G = len(genome_sketches)
    if G < 64:
        return None
    from ..constants import MIN_ANI_DEF, MIN_ANI_P_DEF
    min_ani = (opts.minimum_ani / 100.0 if opts.minimum_ani is not None
               else (MIN_ANI_P_DEF if opts.pseudotax else MIN_ANI_DEF))
    from ..utils.timing import stage_timer
    if device_engine is None:
        with stage_timer("prefilter: host probes"):
            hist = genome_hists(host_counts_chunks(genome_sketches, sample),
                                G)
    else:
        with stage_timer("prefilter: device mask call"):
            mask = device_engine.candidates_mask(sample, dict(
                k=int(genome_sketches[0].k), min_ani=min_ani,
                min_number_kmers=opts.min_number_kmers,
                min_count_correct=opts.min_count_correct,
                no_adj=opts.no_adj))
        if mask is not None:
            return np.flatnonzero(mask)
        hist = device_engine.hists(sample).astype(np.int64)
        assert hist.shape == (G, _H)
    n_kmers = np.array([g.genome_kmers.size for g in genome_sketches],
                       dtype=np.int64)
    keep = candidate_mask(
        hist, n_kmers, k=int(genome_sketches[0].k), min_ani=min_ani,
        min_number_kmers=opts.min_number_kmers,
        min_count_correct=opts.min_count_correct, no_adj=opts.no_adj)
    return np.flatnonzero(keep)
