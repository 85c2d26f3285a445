"""The bucket deployment: a custom database of 2^24 to 2^26 index k-mers
in the port's bucket regime, resident on the card, a sample profiled
against it through the regime's engine (``gpu/bucket_join.py::
BucketEngine``, the one ``engine/device_exec.py::DeviceContainment``
builds in that regime).

  load      the benchmark's flat index (gen/index.py::FlatIndex) put back
            in genome order (a stable sort of its genome ids) and handed
            over as the CLI hands its index over
            (``containment.build_host_index``, padded by ``padded_slots``)
            to ``BucketEngine``, in chunks of the port's
            ``DeviceContainment.CHUNK`` slots (a tiny cut sets
            ``chunk_slots`` in its place): the host bucket layout and its
            upload are made here, the histogram's bin bases at the
            engine's first call (the warm-up). Each chunk's geometry is
            kept for ``kernel_work``, which runs after ``unload``
  dispatch  span "seed":   ``gpu/pipeline.py::sketch_batch_packed`` a batch
                           (unpack, B6), the batches' keys concatenated
            span "bucket": ``BucketEngine.hist_device_stream`` of that
                           occurrence stream (the fold, then per chunk B1,
                           B5' and the binning)
            span "stats":  ``gpu/stats.py::stats_from_histograms``, packed
                           with the probe
            span "fetch":  one copy of the result to the host, queued
  finish    the wait for that copy. Where the probe is not 0 (a fill
            dropped sample entries for want of lanes): span "retry", the
            call again with the sample capacity doubled, until it is 0;
            the result counts as retried where the engine's ``refills``
            counter moved

No sizing hint measured from the sample beforehand is passed: the engine
sizes its capacity itself, and every retry is inside the measured time.
"""

import numpy as np
import torch
from sylph_tpu_torch.engine.device_exec import DeviceContainment
from sylph_tpu_torch.gpu import grange, pipeline
from sylph_tpu_torch.gpu import stats as gstats
from sylph_tpu_torch.gpu.bucket_join import (BucketEngine, padded_slots,
                                             sample_cs)
from sylph_tpu_torch.gpu.containment import build_host_index

from ..bounds import bucket, work
from ..gen.index import FlatIndex
from ..result import Fetch, Result, pack, unpack


class Driver:
    def __init__(self, cfg: dict, device):
        self.dev = device
        spec = cfg["index"]
        self.index = FlatIndex(spec, device)
        self.G, self.c, self.k = self.index.G, spec["c"], spec["k"]
        self.chunk = spec.get("chunk_slots", DeviceContainment.CHUNK)
        self.H = cfg["stats"]["hist_bins"]
        self.min_ani = cfg["stats"]["min_ani"]
        self.engine = self.n_kmers = self.layouts = None

    def load(self):
        _g, order = torch.sort(self.index.gids, stable=True)
        keys = self.index.keys[order]
        n_kmers = torch.bincount(self.index.gids.to(torch.int64),
                                 minlength=self.G)
        sizes = n_kmers.cpu().numpy()
        m = padded_slots(keys.numel(), self.chunk)
        host = build_host_index(
            np.split(keys.cpu().numpy(), np.cumsum(sizes)[:-1]),
            pad_multiple=m)
        self.engine = BucketEngine(host, self.c, chunk=self.chunk,
                                   device=self.dev)
        self.n_kmers = n_kmers.to(torch.int32)
        self.layouts = [bucket.Layout(ch.n_buckets, ch.key.shape[1],
                                      ch.width, (ch.key != -1).sum(1).cpu())
                        for ch in self.engine.chunks]

    def unload(self):
        self.engine = None

    def instrument(self, spans):
        """Nothing to add: every layer is one call of its own here."""

    def _call(self, sample, spans, cs=None):
        """(packed statistics and probe, histogram [G, H]) of a sample,
        queued: ``(stream,)`` an occurrence stream, or ``(keys, weights)``
        a folded table."""
        hist, probe = self.engine.hist_device_stream(
            *sample, n_buckets=self.H, cs=cs)
        with spans("stats"):
            st = gstats.stats_from_histograms(hist, self.n_kmers, k=self.k,
                                              min_ani=self.min_ani)
            out = pack(st, torch.stack((probe, torch.zeros_like(probe))))
        return out, hist

    def dispatch(self, packed, lengths, spans, keep: bool):
        with spans("seed"):
            stream = torch.cat([pipeline.sketch_batch_packed(
                b, lengths, c=self.c, k=self.k,
                device=self.dev)[0].reshape(-1) for b in packed])
        with spans("bucket"):
            out, hist = self._call((stream,), spans)
        with spans("fetch"):
            out = Fetch(out)
        return dict(out=out, stream=stream, keep=keep,
                    hist=hist if keep else None)

    def finish(self, p: dict, spans) -> Result:
        stats, probe = unpack(p["out"].get(), self.G)
        keep = p["keep"]
        if probe[0] == 0:
            return Result(stats, p["hist"], p["stream"] if keep else None)
        refills = self.engine.counters["refills"]
        with spans("retry"):
            table = grange.fold_stream(p["stream"], clamp=self.H - 1)
            cs = self.engine.cs(int(table[0].shape[0]))
            while probe[0] != 0:
                cs *= 2
                out, hist = self._call(table, spans, cs=cs)
                stats, probe = unpack(Fetch(out).get(), self.G)
        return Result(stats, hist if keep else None,
                      p["stream"] if keep else None,
                      retried=self.engine.counters["refills"] > refills)

    def kernel_work(self, sketch, matched, lengths, n_batches: int,
                    row_len: int, retried: bool = False):
        """{kernel: [(bytes, clocks) a launch]} of one sample of this run:
        B6 a batch, B1 and B5' a chunk, at the sample capacity the engine
        gives (``sample_cs`` of the sample's distinct keys at the chunk's
        bucket count), and again at twice it where the sample was run
        again (the first retry's)."""
        keys, counts = sketch
        b6 = [work.seed_pack_launch(lengths.numel(), row_len, lengths,
                                    float(counts.sum()) / n_batches,
                                    self.k)] * n_batches
        t = keys.numel()
        b1, b5 = [], []
        for x in ((1, 2) if retried else (1,)):
            live = {}
            for lay in self.layouts:
                CS = x * sample_cs(t, lay.B)
                geo = (lay.B, lay.width, CS)
                if geo not in live:
                    live[geo] = bucket.lanes(keys, lay, CS)
                b1.append(bucket.fill_launch(t, lay, CS))
                b5.append(bucket.join_launch(lay, live[geo], CS))
        return {"B6": b6, "B1": b1, "B5p": b5}
