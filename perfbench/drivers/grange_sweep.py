"""The grange deployment: a GTDB-scale index resident on the card in the
grange layout, a sample profiled against it through the port's one-shot
calls.

  load      the benchmark's layout (gen/grange_index.py::chunk_layout, as
            a SYLPH_GRANGE_CACHE load would hand it over) wrapped in
            ``gpu/grange.py::GRangeIndex`` and served by ``GRangeEngine``
  dispatch  span "seed":  ``gpu/pipeline.py::sketch_batch_packed`` a batch
                          (unpack, B6), the batches' keys concatenated
            span "sweep": ``gpu/grange.py::fold_stream`` of that
                          occurrence stream, then
                          ``GRangeEngine.hist_device_stream`` of the folded
                          sample (B1, B2/B4, B3, bincount): the work that
                          hist_device_stream does on the stream itself,
                          with the folded sample kept for a retry
            span "stats": ``gpu/stats.py::stats_from_histograms``, packed
            span "fetch": one copy of the result to the host, queued
  finish    the wait for that copy. Where the probe shows a capacity
            violation: span "retry", the sweep again on the device with
            the cell capacity 8 lanes above the one the engine chose (the
            retry after a failed probe that hist_device_stream's docstring
            names, by the step of sylph_tpu_torch/bench.py's retry); where
            that fails too, span "fallback", the per-chunk path
            (``GRangeEngine.hists`` of the host table), as the docstring
            tells callers to

No sizing hint measured from the sample beforehand is passed: the engine
sizes its capacities itself, and every retry is inside the measured time.
"""

import numpy as np
import torch
from sylph_tpu_torch.gpu import grange, pipeline
from sylph_tpu_torch.gpu import stats as gstats
from sylph_tpu_torch.gpu.keys import HIST_H

from ..bounds import work
from ..gen import grange_index
from ..gen.index import GrangeIndex
from ..result import Fetch, Result, pack, unpack


class Driver:
    def __init__(self, cfg: dict, device):
        self.dev = device
        spec = cfg["index"]
        self.index = GrangeIndex(spec, device)
        self.G, self.c, self.k = self.index.G, spec["c"], spec["k"]
        self.H = cfg["stats"]["hist_bins"]
        if self.H != HIST_H:
            raise ValueError(f"the grange engine's histograms have {HIST_H} "
                             f"bins, the configuration states {self.H}")
        self.min_ani = cfg["stats"]["min_ani"]
        self.engine = None

    def load(self):
        geo = self.index.geo
        keys, gids = zip(*(grange_index.chunk_layout(geo, i, self.dev)
                           for i in range(geo.n_chunks)))
        n_kmers = sum(torch.bincount(g.reshape(-1), minlength=self.G + 1)
                      for g in gids)[:self.G]
        self.n_kmers = n_kmers.to(torch.int32)
        gidx = grange.GRangeIndex(
            list(keys), list(gids),
            np.array([geo.base(i) for i in range(geo.n_chunks)], np.uint32),
            np.array([geo.edges(i) for i in range(geo.n_chunks)], np.uint64),
            geo.width, geo.B, geo.CI, np.empty(0, np.uint64),
            np.empty(0, np.int32), int(n_kmers.sum()), self.G, nt=geo.nt,
            ov=grange_index.OV if geo.nt > 1 else 0)
        self.engine = grange.GRangeEngine(gidx, device=self.dev)

    def unload(self):
        self.engine = None

    def instrument(self, spans):
        """Nothing to add: every layer is one call of its own here."""

    def _seed(self, packed, lengths):
        return torch.cat([pipeline.sketch_batch_packed(
            b, lengths, c=self.c, k=self.k, device=self.dev)[0].reshape(-1)
            for b in packed])

    def _stats(self, hist):
        return gstats.stats_from_histograms(hist, self.n_kmers, k=self.k,
                                            min_ani=self.min_ani)

    def _sweep(self, skey, w, spans, cs=None):
        """(packed statistics and probe, histogram [G, H], P) of a folded
        sample, queued."""
        hist, probe, P = self.engine.hist_device_stream(skey, w, cs=cs)
        with spans("stats"):
            h = hist[:self.G * self.H].view(self.G, self.H)
            out = pack(self._stats(h), probe)
        return out, h, P

    def dispatch(self, packed, lengths, spans, keep: bool):
        with spans("seed"):
            stream = self._seed(packed, lengths)
        with spans("sweep"):
            skey, w = grange.fold_stream(stream)
            out, h, P = self._sweep(skey, w, spans)
        with spans("fetch"):
            out = Fetch(out)
        return dict(out=out, P=P, skey=skey, w=w, keep=keep,
                    stream=stream if keep else None, hist=h if keep else None)

    def finish(self, p: dict, spans) -> Result:
        stats, probe = unpack(p["out"].get(), self.G)
        if probe[0] == 0 and probe[1] <= p["P"]:
            return Result(stats, p["hist"], p["stream"])
        skey, w = p["skey"], p["w"]
        with spans("retry"):
            _P, cs, _d = self.engine.plan_stream(int(skey.shape[0]))
            out, h, P = self._sweep(skey, w, spans, cs=cs + 8)
            stats, probe = unpack(Fetch(out).get(), self.G)
        if probe[0] == 0 and probe[1] <= P:
            return Result(stats, h if p["keep"] else None, p["stream"],
                          retried=True)
        with spans("fallback"):
            h = torch.from_numpy(self.engine.hists(
                skey.cpu().numpy().view(np.uint64), w.cpu().numpy())
            ).to(self.dev)
            zero = torch.zeros(2, dtype=torch.int64, device=self.dev)
            stats, _ = unpack(Fetch(pack(self._stats(h), zero)).get(),
                              self.G)
        return Result(stats, h if p["keep"] else None, p["stream"],
                      retried=True, fallback=True)

    def kernel_work(self, sketch, matched, lengths, n_batches: int,
                    row_len: int, retried: bool = False):
        """{kernel: [(bytes, clocks) a launch]} of one sample of this run:
        B6 a batch, B2 a chunk, twice where the sample was swept again (a
        retry's compares and bytes are the first sweep's: they follow the
        live lanes, not the capacity)."""
        geo = self.index.geo
        keys, counts = sketch
        b6 = [work.seed_pack_launch(lengths.numel(), row_len, lengths,
                                    float(counts.sum()) / n_batches,
                                    self.k)] * n_batches
        lanes = work.cell_lanes(keys, geo).cpu()
        b2 = []
        for i in range(geo.n_chunks):
            ct = grange_index.cell_counts(geo, i, 0, geo.B, "cpu")
            tile = torch.clamp(ct, max=geo.tile)
            over = (ct - tile).sum(1)
            b2.append(work.join_codes_launch(geo.B * geo.CI, tile, over,
                                             lanes[i], int(matched[i])))
        return {"B6": b6, "B2": b2 * (2 if retried else 1)}
