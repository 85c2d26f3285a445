"""Device execution engine for query/profile containment (counterpart of
sylph_tpu/engine/device_exec.py), grange regime only.

At database scale (>= GRANGE_MIN index k-mers) the index lives on the
device in the globally hash-sorted, range-chunked grange layout
(gpu/grange.py). Per sample the device produces the per-genome coverage
HISTOGRAM (or just the [G] candidate mask for the prefilter); exact
per-k-mer counts for the few surviving genomes come from the host probe,
so statistics stay in host f64 and TSVs stay byte-identical to the host
engine.
"""

import logging
import threading
from typing import List

import numpy as np
import torch

from ..core.types import GenomeSketch, SequencesSketch
from ..gpu.grange import GRangeEngine, build_grange_index, resolve_device
from ..utils.timing import stage_timer

log = logging.getLogger("sylph")

_HISTS_CACHE_CAP = 16           # fallback histograms kept for the prefilter


class DeviceContainment:
    """Holds the grange index on the device; serves per-sample histograms
    and candidate masks. ``device`` defaults to the GPU; asking for it
    without one raises."""

    GRANGE_MIN = 1 << 26  # global-range layout at/above this total size

    def __init__(self, genome_sketches: List[GenomeSketch], device="cuda"):
        self.device = resolve_device(device)
        self._genome_sketches = genome_sketches
        total = int(sum(g.genome_kmers.size for g in genome_sketches))
        if total < self.GRANGE_MIN:
            raise NotImplementedError(
                f"index of {total} k-mers is below GRANGE_MIN "
                f"({self.GRANGE_MIN}): the merge and bucket regimes of "
                "smaller databases are not ported yet")
        self._hists_cache = {}      # id(sample) -> (ref, [G, 64])
        self._mask_matches_hint = None    # last stream sweep's matches
        with stage_timer(f"grange index build ({total} k-mers)"):
            kmers = np.concatenate(
                [g.genome_kmers for g in genome_sketches]).astype(np.uint64)
            gids = np.repeat(
                np.arange(len(genome_sketches), dtype=np.int32),
                [g.genome_kmers.size for g in genome_sketches])
            gidx = build_grange_index(kmers, gids, len(genome_sketches),
                                      device=self.device)
            del kmers, gids
        max_res = self._grange_residency(gidx)
        with stage_timer("grange index upload"):
            self._grange = GRangeEngine(gidx, device=self.device,
                                        max_resident_chunks=max_res)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        log.debug(
            "Device index (grange): %d genomes, %d k-mers, %d chunks of "
            "[%d, %d] buckets (%s resident), %d spilled, on %s",
            len(genome_sketches), total, len(gidx.chunk_keys), gidx.B,
            gidx.CI, "all" if max_res is None else max_res,
            gidx.spill_kmers.size, self.device)

    def _grange_residency(self, gidx):
        """Resident-chunk cap when the index exceeds 70% of device memory
        (None = everything resident). Chunks past the cap upload per
        sample."""
        if self.device.type != "cuda":
            return None
        n_chunks = len(gidx.chunk_keys)
        chunk_bytes = gidx.B * gidx.CI * 12
        _free, total = torch.cuda.mem_get_info(self.device)
        cap = int(0.7 * total) // max(chunk_bytes, 1)
        return None if cap >= n_chunks else max(1, cap)

    def sample_streamer(self):
        """A DeviceSampleStream for a sample about to be sketched from raw
        reads: the runner hands its push to the sketcher, so the sample's
        k-mers upload while the file is still decoding."""
        from .device_sketch import DeviceSampleStream
        return DeviceSampleStream(self.device)

    def candidates_mask(self, sample: SequencesSketch, mask_kwargs: dict):
        """[G] bool candidate mask computed ON DEVICE, or None when the
        index has heavy runs (their marker bins expand on the host) or a
        degenerate spill list. Spill only ADDS counts, so genomes with any
        spill hit are OR-ed into the candidate set (superset-safe)."""
        g = self._grange.gidx
        if g.n_heavy or g.spill_kmers.size > (1 << 20):
            return None
        from .prefilter import candidate_mask_device
        if not hasattr(self, "_n_kmers_dev"):
            self._n_kmers_dev = torch.tensor(
                [s.genome_kmers.size for s in self._genome_sketches],
                dtype=torch.int32, device=self.device)

        def mask_fn(hist_dev):
            return candidate_mask_device(hist_dev, self._n_kmers_dev,
                                         **mask_kwargs)

        dv = sample._device_view
        table_fn = _warm_table(sample, dv is not None)
        with stage_timer(
                f"device grange candidate mask ({g.m} k-mers x "
                f"{sample.kmers.size} sample k-mers)"):
            out = None
            if dv is not None:
                # one-dispatch stream sweep: a single fused probe + mask
                # fetch. The previous sample's measured match total (x1.5
                # margin, rounded up to a half-octave step) sizes the code
                # compaction for the actual hit rate; an underestimate
                # fails the probe and the sweep reruns without the hint.
                hint = self._mask_matches_hint
                if hint:
                    hint = int(2.0 ** (np.ceil(2.0 * np.log2(
                        max(hint * 1.5, 2.0))) / 2.0)) + 1
                ms = self._grange.candidate_mask_stream(dv, mask_fn,
                                                        n_matches=hint)
                if ms is None and hint:
                    ms = self._grange.candidate_mask_stream(dv, mask_fn)
                if ms is not None:
                    out, self._mask_matches_hint = ms
            if out is None:
                out = self._grange.hists(None, None, mask_fn=mask_fn,
                                         device_view=dv, table_fn=table_fn)
        if out.ndim == 2:
            # a chunk failed its conservation check and the engine returned
            # the full histogram: cache it for the host prefilter path
            self._hists_cache[id(sample)] = (sample, out)
            while len(self._hists_cache) > _HISTS_CACHE_CAP:
                self._hists_cache.pop(next(iter(self._hists_cache)))
            return None
        if g.spill_kmers.size:
            sh = self._grange._spill_hist(*table_fn())
            out = out | (sh[:, 1:].sum(axis=1) > 0)
        return out

    def hists(self, sample: SequencesSketch) -> np.ndarray:
        """[G, 64] per-genome multiplicity histograms for the prefilter."""
        hit = self._hists_cache.get(id(sample))
        if hit is not None and hit[0] is sample:
            return hit[1]
        dv = sample._device_view
        table_fn = _warm_table(sample, dv is not None)
        with stage_timer(
                f"device grange hists ({self._grange.gidx.m} k-mers x "
                f"{sample.kmers.size} sample k-mers)"):
            return self._grange.hists(None, None, device_view=dv,
                                      table_fn=table_fn)

    def genome_covs(self, genome_index: int, sample: SequencesSketch,
                    winner=None, self_group: int = -1):
        """Exact counts for one (candidate) genome come from the host
        probe, the f64 parity oracle."""
        from .containment import genome_covs as host_covs
        return host_covs(self._genome_sketches[genome_index], sample,
                         winner, self_group)


def _warm_table(sample, overlap: bool):
    """() -> (sorted_kmers_u64, counts) supplier for the grange sweep.

    With ``overlap`` (a device-resident sample view is present) the host
    sort runs on a side thread, overlapping the device sweep: only the
    spill probe and the per-chunk path consume the table. Without a view
    the sweep needs the table at once, so it is sorted inline."""
    if not overlap:
        sk, sc = sample.sorted_view()
        return lambda: (sk.astype(np.uint64, copy=False), sc)
    th = threading.Thread(target=sample.sorted_view, daemon=True)
    th.start()

    def table_fn():
        th.join()
        sk, sc = sample.sorted_view()
        return sk.astype(np.uint64, copy=False), sc
    return table_fn
