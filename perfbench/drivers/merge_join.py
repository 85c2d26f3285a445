"""The merge deployment: a custom database's flat index (keys sorted, with
their genome ids) resident on the card, a sample profiled against it
through the port's one-shot pipeline.

  load      the benchmark's flat index (gen/index.py::FlatIndex) kept as the
            port's ``finish_profile`` takes it
  dispatch  span "seed":   ``gpu/pipeline.py::sketch_batch_packed`` a batch
                           (unpack, B6), the batches' keys concatenated
            span "finish": ``gpu/pipeline.py::finish_profile`` (the merge
                           join, ``genome_hist``, the statistics), packed;
                           in a traced window its two parts get spans of
                           their own, "join" and "stats"
            span "fetch":  one copy of the result to the host, queued
  finish    the wait for that copy
"""

import torch
from sylph_tpu_torch.gpu import pipeline

from ..bounds import work
from ..gen.index import FlatIndex
from ..result import Fetch, Result, pack, unpack


def _spanned(fn, spans, name):
    def call(*args, **kw):
        with spans(name):
            return fn(*args, **kw)
    return call


class Driver:
    def __init__(self, cfg: dict, device):
        self.dev = device
        spec = cfg["index"]
        self.index = FlatIndex(spec, device)
        self.G, self.c, self.k = self.index.G, spec["c"], spec["k"]
        self.H = cfg["stats"]["hist_bins"]
        self.min_ani = cfg["stats"]["min_ani"]
        self.n_kmers = None
        self._saved = None

    def load(self):
        self.n_kmers = torch.bincount(self.index.gids.to(torch.int64),
                                      minlength=self.G).to(torch.int32)

    def unload(self):
        self.n_kmers = None

    def instrument(self, spans):
        """Spans around the join and the statistics inside
        ``finish_profile`` (the names it calls), until ``instrument(None)``."""
        if self._saved is not None:
            pipeline.merge_join_hist, pipeline.stats_from_histograms = \
                self._saved
            self._saved = None
        if spans is not None:
            self._saved = (pipeline.merge_join_hist,
                           pipeline.stats_from_histograms)
            pipeline.merge_join_hist = _spanned(self._saved[0], spans,
                                                "join")
            pipeline.stats_from_histograms = _spanned(self._saved[1], spans,
                                                      "stats")

    def dispatch(self, packed, lengths, spans, keep: bool):
        with spans("seed"):
            stream = torch.cat([pipeline.sketch_batch_packed(
                b, lengths, c=self.c, k=self.k,
                device=self.dev)[0].reshape(-1) for b in packed])
        with spans("finish"):
            hist, st = pipeline.finish_profile(
                stream, self.index.keys, self.index.gids, self.n_kmers,
                k=self.k, n_genomes=self.G, n_buckets=self.H,
                min_ani=self.min_ani, device=self.dev)
            out = pack(st, torch.zeros(2, dtype=torch.int64,
                                       device=self.dev))
        with spans("fetch"):
            out = Fetch(out)
        return dict(out=out, stream=stream if keep else None,
                    hist=hist if keep else None)

    def finish(self, p: dict, spans) -> Result:
        stats, _ = unpack(p["out"].get(), self.G)
        return Result(stats, p["hist"], p["stream"])

    def kernel_work(self, sketch, matched, lengths, n_batches: int,
                    row_len: int, retried: bool = False):
        """{kernel: [(bytes, clocks) a launch]}: B6 a batch (the merge
        join runs no hand-written kernel)."""
        _keys, counts = sketch
        return {"B6": [work.seed_pack_launch(
            lengths.numel(), row_len, lengths,
            float(counts.sum()) / n_batches, self.k)] * n_batches}
