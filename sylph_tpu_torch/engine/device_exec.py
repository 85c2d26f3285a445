"""Device execution engine for query/profile containment (counterpart of
sylph_tpu/engine/device_exec.py).

Three regimes by total index size, as in the JAX package:
  - merge (< BUCKET_MIN): the index sits on the device whole; per sample,
    gpu/containment.py::merge_join_counts gives exact per-k-mer counts
    (one sort of the sample table), cached per sample.
  - bucket (< GRANGE_MIN): each CHUNK-slot chunk is laid out dense per hash
    bucket once (gpu/bucket_join.py::BucketEngine); per sample, the B1 fill
    and the B5' compare give the prefilter's per-genome histograms on the
    device, and the same exact counts where the statistics read them.
  - grange (>= GRANGE_MIN, database scale): the globally hash-sorted,
    range-chunked layout (gpu/grange.py). Per sample the device produces
    the per-genome coverage HISTOGRAM (or just the [G] candidate mask);
    exact per-k-mer counts for the few surviving genomes come from the
    host probe.
In the merge and bucket regimes the exact statistics read the cached device
counts (genome_covs). Statistics stay in host f64 either way, so TSVs stay
byte-identical to the host engine. ``prefetch`` batches a cohort of samples
(merge: one batched join; grange: one batched histogram sweep; bucket:
nothing, its samples are served one at a time).

Several devices and processes, as in the JAX package (device_exec.py:
101-174). ``devices`` (default: every visible GPU for "cuda", one CPU device
for "cpu"), cut to the first ``SYLPH_TPU_DEVICES``; asking for more than
exist raises. Below GRANGE_MIN on more than one device the index shards
evenly over the devices and every sample joins each shard (the sharded
merge join; never the bucket regime). In the grange regime the chunks go
round-robin over the devices, and in a process group of several processes
(utils/distributed.py) each process owns a round-robin share of the chunks
and ``hists`` sums the processes' partial histograms. The streamed device
view, the device candidate mask and the batched grange sweep are
one-device, one-process paths: elsewhere samples are swept one at a time
from their host tables.

``SYLPH_GRANGE_CACHE=DIR`` keeps the grange layout on disk: the first call
on a database builds it and saves it under DIR, later calls load it. The
key is the genome count, the total k-mers, a content fingerprint and the
layout's ``nt`` setting, so a database whose content changed rebuilds.
"""

import logging
import os
import threading
from typing import List, Optional

import numpy as np
import torch

from ..core.types import GenomeSketch, SequencesSketch
from ..gpu.bucket_join import BucketEngine, padded_slots
from ..gpu.containment import (build_host_index, merge_join_counts,
                                merge_join_counts_batched,
                                merge_join_counts_sharded,
                                merge_join_counts_sharded_batched,
                                shard_index)
from ..gpu.grange import (GRangeEngine, GRangeIndex, build_grange_index,
                          merge_process_hists, resolve_device)
from ..gpu.keys import HIST_H, KEY_PAD
from ..utils.distributed import process_count, process_index
from ..utils.timing import stage_timer, wait

log = logging.getLogger("sylph")

_CACHE_CAP = 16      # cached samples per cache; a prefetch grows it to S + 2


def resolve_devices(device="cuda", devices=None) -> List[torch.device]:
    """The engine's device list: ``devices``, else every visible GPU for
    "cuda" (one for "cuda:i") and one CPU device for "cpu", cut to the first
    ``SYLPH_TPU_DEVICES``. Raises where the variable asks for more devices
    than the list holds, or for CUDA without a GPU: nothing falls back."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            devs = [dev]
    if not devs:
        raise ValueError("no device to run containment on")
    env = os.environ.get("SYLPH_TPU_DEVICES")
    if env:
        n = max(1, int(env))
        if n > len(devs):
            raise ValueError(f"SYLPH_TPU_DEVICES={n} asks for more devices "
                             f"than the {len(devs)} there are: "
                             + ", ".join(map(str, devs)))
        devs = devs[:n]
    return devs


class DeviceContainment:
    """Holds the genome index on the device(s); serves per-sample counts,
    histograms and candidate masks. ``device`` defaults to the GPU (every
    visible one); asking for it without one raises. ``devices`` names the
    devices outright (tests pass ``[cpu, cpu]``); a list may name one card
    more than once."""

    CHUNK = 1 << 22       # index k-mers per device call (merge, bucket)
    BUCKET_MIN = 1 << 24  # bucketed join at/above this total index size
    GRANGE_MIN = 1 << 26  # global-range layout at/above this total size

    def __init__(self, genome_sketches: List[GenomeSketch], device="cuda",
                 devices=None):
        self.devices = resolve_devices(device, devices)
        self.device = self.devices[0]
        self._genome_sketches = genome_sketches
        self._grange = None
        self._bucket = None         # the bucket regime's BucketEngine
        self._grange_span = None    # (process index, processes) or None
        self._shards = None         # sharded merge join: per-device index
        self._cache = {}            # id(sample) -> (ref, [M] int32 counts)
        self._hists_cache = {}      # id(sample) -> (ref, [G, 64])
        self._cache_cap = _CACHE_CAP
        # merge-regime prefetches (batched joins) and sharded joins (one a
        # sample, or one a batch)
        self.counters = {"batched_joins": 0, "sharded_joins": 0}
        total = int(sum(g.genome_kmers.size for g in genome_sketches))
        if total >= self.GRANGE_MIN:
            self._init_grange(total)
        elif len(self.devices) > 1:
            self._init_sharded(total)
        else:
            self._init_chunks(total)

    def _init_chunks(self, total: int):
        """The merge and bucket regimes: the index padded to m slots, the
        next power of two (>= 1024) or the next whole number of CHUNKs,
        whichever is smaller. Pads are key 0 with genome id G. The merge
        regime uploads it whole; the bucket regime cuts it into CHUNK-slot
        chunks, and since live k-mers are a prefix of the index, a chunk's
        live k-mers are a prefix of the chunk."""
        gs = self._genome_sketches
        self.index = build_host_index([g.genome_kmers for g in gs],
                                      pad_multiple=padded_slots(total,
                                                                self.CHUNK))
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.index.n_kmers.astype(np.int64))])
        m = self.index.keys.size
        self._use_buckets = total >= self.BUCKET_MIN
        self._index_dev, self._bchunks = None, []
        regime = "bucket" if self._use_buckets else "merge"
        with stage_timer(f"{regime} index build",
                         detail=f"({total} k-mers)"):
            if self._use_buckets:
                self._bucket = BucketEngine(
                    self.index, min(g.c for g in gs), chunk=self.CHUNK,
                    device=self.device)
                self._bchunks = self._bucket.chunks
            else:
                self._index_dev = torch.from_numpy(self.index.keys).to(
                    self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        log.debug("Device index (%s): %d genomes, %d k-mers in %d slots%s, "
                  "on %s", regime, len(gs), total, m,
                  "".join(f", {len(self._bchunks)} chunk(s) of "
                          f"[{b.n_buckets}, {b.key.shape[1]}]"
                          for b in self._bchunks[:1]), self.device)

    def _init_sharded(self, total: int):
        """Below GRANGE_MIN on n > 1 devices (device_exec.py:242-281): the
        index padded to m = 1024 n slots, doubled until it holds the total,
        and cut into n equal shards, one a device. Every sample joins each
        shard; the counts concatenate in shard order."""
        n_dev = len(self.devices)
        m = 1024 * n_dev
        while m < total:
            m *= 2
        gs = self._genome_sketches
        self.index = build_host_index([g.genome_kmers for g in gs],
                                      pad_multiple=m)
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.index.n_kmers.astype(np.int64))])
        self._use_buckets, self._index_dev, self._bchunks = False, None, []
        with stage_timer("sharded index build",
                         detail=f"({total} k-mers)"):
            self._shards = shard_index(self.index.keys, self.devices)
            for d in {d for d in self.devices if d.type == "cuda"}:
                torch.cuda.synchronize(d)
        log.debug("Device index (sharded): %d genomes, %d k-mers in %d "
                  "slots over %d device(s)", len(gs), total,
                  self.index.keys.size, n_dev)

    def _init_grange(self, total: int):
        genome_sketches = self._genome_sketches
        self._mask_matches_hint = None    # last stream sweep's matches
        cache = os.environ.get("SYLPH_GRANGE_CACHE")
        path = _grange_cache_path(cache, total, genome_sketches) \
            if cache else None
        gidx = None
        # a process group of several processes (utils/distributed.py):
        # this process owns a round-robin share of the chunks on its own
        # devices, and hists() merges the partial histograms
        if process_count() > 1:
            self._grange_span = (process_index(), process_count())
        if path is not None and os.path.exists(os.path.join(path, _META)):
            with stage_timer("grange cache load"):
                gidx = _grange_cache_load(path, total, len(genome_sketches),
                                          self._grange_span)
        if gidx is None:
            with stage_timer("grange index build",
                             detail=f"({total} k-mers)"):
                kmers = np.concatenate(
                    [g.genome_kmers for g in genome_sketches]
                ).astype(np.uint64)
                gids = np.repeat(
                    np.arange(len(genome_sketches), dtype=np.int32),
                    [g.genome_kmers.size for g in genome_sketches])
                gidx = build_grange_index(kmers, gids, len(genome_sketches),
                                          device=self.device)
                del kmers, gids
            # every process builds the whole layout; only process 0 saves it
            if path is not None and (self._grange_span is None
                                     or self._grange_span[0] == 0):
                with stage_timer("grange cache save"):
                    _grange_cache_save(path, gidx)
        max_res = self._grange_residency(gidx)
        with stage_timer("grange index upload"):
            self._grange = GRangeEngine(gidx, devices=self.devices,
                                        max_resident_chunks=max_res,
                                        process_span=self._grange_span)
            for d in {d for d in self.devices if d.type == "cuda"}:
                torch.cuda.synchronize(d)
        log.debug(
            "Device index (grange): %d genomes, %d k-mers, %d chunks of "
            "[%d, %d] buckets (%s resident), %d spilled, over %d device(s), "
            "process span %s", len(genome_sketches), total,
            len(gidx.chunk_keys), gidx.B, gidx.CI,
            "all" if max_res is None else max_res, gidx.spill_kmers.size,
            len(self.devices), self._grange_span)

    def _grange_residency(self, gidx):
        """Resident-chunk cap when the index exceeds 70% of the devices'
        memory (None = everything resident): the chunks that fit in one
        device, times the count of distinct devices (logical devices on one
        card share its memory). Chunks past the cap upload per sample.
        SYLPH_HBM_GB (GB, 1e9 bytes) replaces a device's memory, on any
        device, as in the JAX package."""
        env = os.environ.get("SYLPH_HBM_GB")
        if not env and self.device.type != "cuda":
            return None
        n_chunks = len(gidx.chunk_keys)
        chunk_bytes = gidx.B * gidx.CI * 12
        if env:
            total = float(env) * 1e9
        else:
            _free, total = torch.cuda.mem_get_info(self.device)
        n_cards = len(set(self.devices))
        cap = int(0.7 * total) // max(chunk_bytes, 1) * n_cards
        return None if cap >= n_chunks else max(1, cap)

    def serves_histograms(self) -> bool:
        """True iff the grange regime: the engine serves histograms only,
        so exact statistics probe the host."""
        return self._grange is not None

    def serves_streams(self) -> bool:
        """True iff sample_streamer() returns a stream: the grange regime
        on one device in one process."""
        return self._grange is not None and self._grange._one_device()

    def sample_streamer(self):
        """A DeviceSampleStream for a sample about to be sketched from raw
        reads (grange regime; None otherwise): the runner hands its push to
        the sketcher, so the sample's k-mers upload while the file is still
        decoding."""
        if not self.serves_streams():
            return None
        from .device_sketch import DeviceSampleStream
        return DeviceSampleStream(self.device)

    @staticmethod
    def _pad_table(sample: SequencesSketch, t: int):
        """The sample's hash-sorted (int64 keys with a KEY_PAD tail, int32
        weights with a 0 tail) of length t."""
        skmers, scounts = sample.sorted_view()
        keys = np.full(t, KEY_PAD, np.int64)
        wts = np.zeros(t, np.int32)
        keys[:skmers.size] = skmers.astype(np.uint64, copy=False).view(
            np.int64)
        wts[:skmers.size] = scounts
        return keys, wts

    def _counts(self, sample: SequencesSketch) -> np.ndarray:
        """[M] int32 exact sample counts of every index slot (merge and
        bucket regimes), cached by sample identity with a strong ref so a
        collected sample's id cannot alias the cache."""
        hit = self._cached(self._cache, sample)
        if hit is not None:
            return hit
        n = int(sample.kmers.size)
        skey, sw = self.upload_table(sample)
        regime = ("bucketed" if self._use_buckets else "merge"
                  if self._shards is None
                  else f"sharded over {len(self.devices)} devices")
        with stage_timer("device containment join",
                         detail=f"({self.index.keys.size} k-mers x {n} "
                         f"sample k-mers, {regime})"):
            if self._shards is not None:
                self.counters["sharded_joins"] += 1
                counts = merge_join_counts_sharded(self._shards, skey, sw)
            else:
                counts = self.device_counts(skey, sw, n).cpu().numpy()
        self._cache_put(self._cache, sample, counts)
        return counts

    def _cache_put(self, cache: dict, sample, value) -> None:
        """Keep ``value`` for ``sample`` (a strong ref, so a collected
        sample's id cannot alias it), evicting the oldest past the cap."""
        cache[id(sample)] = (sample, value)
        while len(cache) > self._cache_cap:
            cache.pop(next(iter(cache)))

    @staticmethod
    def _cached(cache: dict, sample):
        hit = cache.get(id(sample))
        return hit[1] if hit is not None and hit[0] is sample else None

    def prefetch(self, samples: List[SequencesSketch]) -> None:
        """Batch a cohort's device work (sylph_tpu/engine/device_exec.py:
        302-370). Grange: one batched histogram sweep of the samples that
        have no streamed device view and no cached histogram, when there
        are at least two; merge: one batched join of the uncached samples
        into the counts cache; bucket: nothing. The caches grow to hold the
        whole cohort (S + 2), so no sample evicts another before it is
        read."""
        if self._grange is not None:
            todo = [s for s in samples if s._device_view is None
                    and self._cached(self._hists_cache, s) is None]
            if len(todo) < 2 or not self._grange._one_device():
                return
            with stage_timer("sample tables",
                             detail=f"({len(todo)} samples)"):
                tables = [s.sorted_view() for s in todo]
            self._cache_cap = max(self._cache_cap, len(todo) + 2)
            with stage_timer("batched grange hists",
                             detail=f"({self._grange.gidx.m} k-mers x "
                             f"{len(todo)} samples)"):
                hs = self._grange.hists_batched(tables)
            for s, h in zip(todo, hs):
                self._cache_put(self._hists_cache, s, h)
            return
        todo = [s for s in samples if self._cached(self._cache, s) is None]
        if len(todo) < 2 or self._use_buckets:
            return
        with stage_timer("sample tables", detail=f"({len(todo)} samples)"):
            keys, wts = self.upload_tables(todo)
        self._cache_cap = max(self._cache_cap, len(todo) + 2)
        self.counters["batched_joins"] += 1
        sharded = self._shards is not None
        with stage_timer(f"batched {'sharded ' if sharded else ''}"
                         "containment join",
                         detail=f"({self.index.keys.size} k-mers x "
                         f"{len(todo)} samples x {keys.shape[1]} "
                         "table slots)"):
            if sharded:
                self.counters["sharded_joins"] += 1
                counts = merge_join_counts_sharded_batched(self._shards,
                                                           keys, wts)
            else:
                counts = merge_join_counts_batched(self._index_dev, keys,
                                                   wts).cpu().numpy()
        for s, c in zip(todo, counts):
            self._cache_put(self._cache, s, c)

    def upload_table(self, sample: SequencesSketch):
        """The sample's table on the device, padded to a power of two (at
        least 1024) as the JAX package pads it to bound compile shapes;
        kept, so both engines see the same table."""
        keys, wts = self.upload_tables([sample])
        return keys[0], wts[0]

    def upload_tables(self, samples: List[SequencesSketch]):
        """[S, T] (keys, weights) of the samples' tables on the device, each
        padded as upload_table pads it, T from the largest."""
        t = max(1024, 1 << int(np.ceil(np.log2(max(
            max(s.kmers.size for s in samples), 1)))))
        tabs = [self._pad_table(s, t) for s in samples]
        return (torch.from_numpy(np.stack([k for k, _ in tabs])).to(
                    self.device),
                torch.from_numpy(np.stack([w for _, w in tabs])).to(
                    self.device))

    def device_counts(self, skey: torch.Tensor, sw: torch.Tensor,
                      n: int) -> torch.Tensor:
        """[M] int32 counts on the device of a table from upload_table
        with n live entries: the merge join of the whole index, or per
        chunk the bucket join (B1 + B5')."""
        if not self._use_buckets:
            return merge_join_counts(self._index_dev, skey, sw)
        return self._bucket.counts(skey, sw, n)

    def candidates_mask(self, sample: SequencesSketch, mask_kwargs: dict):
        """[G] bool candidate mask computed ON DEVICE (grange regime, one
        device, one process), or None: outside grange, where the prefilter
        reads the histogram of the exact counts; on several devices or
        processes, where it reads the merged histogram (device_exec.py:
        456-457); for a sample whose histogram ``prefetch`` cached,
        which the prefilter then reads through ``hists`` (the JAX package
        sweeps such a sample again here, device_exec.py:517-529); or when
        the index has heavy runs (their marker bins expand on the host) or
        a degenerate spill list. Spill only ADDS counts, so genomes with
        any spill hit are OR-ed into the candidate set (superset-safe)."""
        if self._grange is None or not self._grange._one_device() or \
                self._cached(self._hists_cache, sample) is not None:
            return None
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
                "device grange candidate mask",
                detail=f"({g.m} k-mers x {sample.kmers.size} sample "
                "k-mers)"):
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
            self._cache_put(self._hists_cache, sample, out)
            return None
        if g.spill_kmers.size:
            sh = self._grange._spill_hist(*table_fn())
            out = out | (sh[:, 1:].sum(axis=1) > 0)
        return out

    def hists(self, sample: SequencesSketch) -> np.ndarray:
        """[G, 64] per-genome multiplicity histograms for the prefilter:
        from the grange sweep, the bucket engine's device histogram, or
        (merge regime) a host bincount of the exact counts."""
        if self._bucket is not None:
            return self._bucket_hists(sample)
        if self._grange is None:
            counts = self._counts(sample)
            gids = self.index.genome_ids
            G = int(self.index.n_genomes)
            m = (counts > 0) & (gids < G)
            seg = (gids[m].astype(np.int64) * 64
                   + np.minimum(counts[m].astype(np.int64), 63))
            return np.bincount(seg, minlength=G * 64).reshape(G, 64)
        hit = self._cached(self._hists_cache, sample)
        if hit is not None:
            return hit
        dv = sample._device_view
        table_fn = _warm_table(sample, dv is not None)
        with stage_timer(
                "device grange hists",
                detail=f"({self._grange.gidx.m} k-mers x "
                f"{sample.kmers.size} sample k-mers)"):
            out = self._grange.hists(None, None, device_view=dv,
                                     table_fn=table_fn)
        if self._grange_span is not None:
            with stage_timer("process hists merge"):
                out = merge_process_hists(out)
        return out

    def _bucket_hists(self, sample: SequencesSketch) -> np.ndarray:
        """[G, 64] int64 histograms of a sample in the bucket regime: the
        engine's whole-database histogram on the device
        (``BucketEngine.hist_device_stream`` of the sample's table), run
        again at a doubled sample capacity while its probe counts entries
        the fills dropped, and fetched with the probe in one copy. Bin 0 is
        left 0, as the merge regime's bincount leaves it; the per-slot
        counts are left to ``genome_covs``."""
        n = int(sample.kmers.size)
        skey, sw = self.upload_table(sample)
        G, cs = int(self.index.n_genomes), None
        with stage_timer("device bucket hists",
                         detail=f"({self.index.keys.size} k-mers x {n} "
                         "sample k-mers)"):
            while True:
                hist, probe = self._bucket.hist_device_stream(
                    skey[:n], sw[:n], n_buckets=HIST_H, cs=cs)
                with wait("bucket.fetch"):
                    host = torch.cat((probe.view(1), hist.view(-1).to(
                        torch.int64))).cpu().numpy()
                if host[0] == 0:
                    break
                cs = 2 * (cs or self._bucket.cs(n))
        out = host[1:].reshape(G, HIST_H)
        out[:, 0] = 0
        return out

    def genome_covs(self, genome_index: int, sample: SequencesSketch,
                    winner=None, self_group: int = -1):
        """(sorted contained multiplicities, kmers_lost) of one genome: the
        engine.containment.genome_covs contract. Grange: the host probe,
        the f64 parity oracle. Merge and bucket: the cached device counts;
        the winner-table owner lookup stays on the host."""
        if self._grange is not None:
            from .containment import genome_covs as host_covs
            return host_covs(self._genome_sketches[genome_index], sample,
                             winner, self_group)
        counts = self._counts(sample)
        s, e = self.offsets[genome_index], self.offsets[genome_index + 1]
        cts = counts[s:e]
        hit = cts > 0
        kmers_lost = 0
        if winner is not None:
            owners = winner.owner_groups(self.index.keys[s:e].view(
                np.uint64))
            owned = owners == self_group
            kmers_lost = int(np.count_nonzero(hit & ~owned))
            hit = hit & owned
        covs = cts[hit].astype(np.uint32)
        covs.sort()
        return covs, kmers_lost


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


# ---- the grange layout cache (SYLPH_GRANGE_CACHE) --------------------------

_META = "meta.npz"


def _grange_fingerprint(genome_sketches) -> str:
    """Cheap content fingerprint of a genome-sketch list: per-genome sizes
    plus three sampled k-mers per genome (first/middle/last of the
    insertion-order array). A rebuilt or swapped syldb that happens to
    match on (n_genomes, total k-mers) alone changes this with overwhelming
    probability, so a stale cached layout cannot silently load."""
    import hashlib
    h = hashlib.sha1()
    sizes = np.array([g.genome_kmers.size for g in genome_sketches],
                     np.int64)
    h.update(sizes.tobytes())
    for g in genome_sketches:
        k = g.genome_kmers
        if k.size:
            h.update(np.asarray([k[0], k[k.size // 2], k[-1]],
                                np.uint64).tobytes())
    return h.hexdigest()[:16]


def _grange_cache_path(cache_dir: str, total: int, genome_sketches) -> str:
    """The layout's directory under ``cache_dir``. The ``torch_`` prefix
    keeps it apart from the JAX package's (hi, lo) layouts, which it
    names ``grange_*`` in the same variable's directory; ``nt<SYLPH_NT>``
    is the layout setting (``ntauto`` where the build chooses nt)."""
    fp = _grange_fingerprint(genome_sketches)
    nt = os.environ.get("SYLPH_NT", "auto")
    return os.path.join(cache_dir, f"torch_grange_{len(genome_sketches)}_"
                        f"{total}_{fp}_nt{nt}")


def _grange_cache_load(path: str, total: int, n_genomes: int,
                       span=None) -> Optional[GRangeIndex]:
    """The layout saved under ``path``, or None when its metadata does not
    describe this database. Under a process span ``(i, n)`` only the grids
    of the chunks j with j % n == i are read (the others are None: an
    engine with that span never touches them)."""
    meta = np.load(os.path.join(path, _META))
    if int(meta["m"]) != total or int(meta["n_genomes"]) != n_genomes:
        return None
    n_chunks = int(meta["n_chunks"])

    def grids(name):
        return [torch.from_numpy(np.load(os.path.join(path, f"{name}{i}.npy")))
                if span is None or i % span[1] == span[0] else None
                for i in range(n_chunks)]
    gidx = GRangeIndex(
        grids("keys"), grids("gid"), meta["bases"], meta["edges_u64"],
        int(meta["width"]), int(meta["B"]), int(meta["CI"]),
        meta["spill_kmers"], meta["spill_gids"], total, n_genomes,
        nt=int(meta["nt"]), ov=int(meta["ov"]),
        heavy_gids=meta["heavy_gids"], heavy_ptr=meta["heavy_ptr"])
    log.debug("grange layout loaded from cache %s", path)
    return gidx


def _grange_cache_save(path: str, gidx: GRangeIndex) -> None:
    """Save the layout under ``path``: per chunk its int64 key grid and
    int32 genome-id grid, then the other fields in the metadata file,
    written last and renamed into place, so an interrupted save is never
    loaded."""
    os.makedirs(path, exist_ok=True)
    for i, (k, g) in enumerate(zip(gidx.chunk_keys, gidx.chunk_gid)):
        np.save(os.path.join(path, f"keys{i}.npy"), k.cpu().numpy())
        np.save(os.path.join(path, f"gid{i}.npy"), g.cpu().numpy())
    tmp = os.path.join(path, f"meta.{os.getpid()}.tmp.npz")
    np.savez(tmp, n_chunks=len(gidx.chunk_keys), bases=gidx.bases,
             edges_u64=gidx.edges_u64, width=gidx.width, B=gidx.B,
             CI=gidx.CI, spill_kmers=gidx.spill_kmers,
             spill_gids=gidx.spill_gids, m=gidx.m, n_genomes=gidx.n_genomes,
             nt=gidx.nt, ov=gidx.ov, heavy_gids=gidx.heavy_gids,
             heavy_ptr=gidx.heavy_ptr)
    os.replace(tmp, os.path.join(path, _META))
    log.debug("grange layout cached to %s", path)
