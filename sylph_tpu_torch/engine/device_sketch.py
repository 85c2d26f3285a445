"""Device read seeding and the streamed device-resident sample (counterpart
of sylph_tpu/engine/device_sketch.py).

Read seeding: reads are packed into fixed-length 2-bit batches (0.25 B a
base up the wire), the B7 kernel emits every window's hash and keep, each
row's survivors are compacted in position order, and the B8 repack
condenses the sparse per-row stream before it leaves the device (per-read
counts ride along). The host-side dedup fold (native C) then runs
unchanged, so sketches are identical to the host seeder's. Reads longer
than the largest bucket are seeded on the host by design
(kmer/seeding.py::fmh_seeds_np); results merge by read id, in file order.

Genome seeding: every contig is cut into rows of _GBLOCK bases that overlap
by k-1 (each window lies in exactly one row), B7 seeds them in batches, and
each row's survivors come back with their window lanes, so the host gets
(contig, end position, hash) in (contig, position) order for the duplicate
drop and the spacing scan (core/sketch_genomes.py).

Streamed sample: the dedup fold's first-insertion order is append-only,
so the sample's distinct k-mers upload WHILE later blocks still decode
(DeviceSampleStream); the grange engine then sorts and slices the sample
on the device (gpu/grange.py, device_view=).
"""

import logging
import queue
import threading
from typing import List

import numpy as np
import torch

from ..gpu.bucket_fill import condense_stream
from ..gpu.seeding import compact_by_position, seed_packed
from ..io.fastx import ParsedFastx
from ..kmer.seeding import fmh_seeds_np

log = logging.getLogger("sylph")

_BUCKETS = (128, 256, 512)     # padded lengths (multiples of 16 and 128)
_MAX_BATCH = 1 << 16           # reads per device call


def _row_cap(W: int, c: int) -> int:
    """Per-read survivor capacity: 8x the FracMinHash expectation + 24."""
    return min(W, 8 * W // c + 24)


def _pack16_rows(codes_u8: np.ndarray) -> np.ndarray:
    """[N, L] uint8 codes -> [N, L/16] uint32 words (LSB-first), host side:
    four codes to a byte, base j of a byte at bits 2j, and four bytes read
    as one little-endian word put base j of the word at bits 2j."""
    N, L = codes_u8.shape
    c = codes_u8.reshape(N, L // 4, 4)
    b = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)
    return np.ascontiguousarray(b).view("<u4").astype(np.uint32, copy=False)


def _seed_rows(packed: torch.Tensor, lens: torch.Tensor, c: int, k: int,
               bucket_len: int) -> torch.Tensor:
    """B7 + per-row compaction: [R, cap] survivors, position order."""
    hash_, keep = seed_packed(packed, lens, c=c, k=k)
    W = bucket_len - k + 1
    return compact_by_position(hash_[:, :W], keep[:, :W], _row_cap(W, c))


def _seed_packed(packed: torch.Tensor, lens: torch.Tensor, c: int, k: int,
                 bucket_len: int):
    """One batch, wire-optimized both ways (the JAX _seed_packed_jit):
    (condensed survivor stream, per-read survivor counts)."""
    rows = _seed_rows(packed, lens, c, k, bucket_len)
    n_r = (rows != -1).sum(dim=1)
    W = bucket_len - k + 1
    exp = (W / c) / rows.shape[1]
    return condense_stream(rows.reshape(-1), exp), n_r


def _gather_rows(padded: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                 L: int):
    """([pad_n, L] uint8 codes, [pad_n] int32 lengths): row i is one
    contiguous copy of L codes from ``starts[i]`` (a row view of
    ``padded``, the codes followed by at least L zeros), with the codes
    past ``lens[i]`` zeroed; rows padded to a multiple of 8."""
    nb = starts.size
    pad_n = -(-nb // 8) * 8
    rows = np.lib.stride_tricks.sliding_window_view(padded, L)
    bases = np.zeros((pad_n, L), np.uint8)
    bases[:nb] = rows[starts]
    bases[:nb] *= np.arange(L)[None, :] < lens[:, None]
    blens = np.zeros(pad_n, np.int32)
    blens[:nb] = lens
    return bases, blens


def _build_batch(px: ParsedFastx, bucket_len: int, rids: np.ndarray):
    """The batch of the reads ``rids`` at padded length bucket_len
    (_gather_rows from each read's start)."""
    padded = np.concatenate([px.codes, np.zeros(bucket_len, np.uint8)])
    return _gather_rows(padded, px.starts[rids],
                        px.lengths[rids].astype(np.int64), bucket_len)


def _upload_batch(bases: np.ndarray, blens: np.ndarray, device):
    """(packed int32 [N, L/16] words, int32 lengths) on ``device``: the
    wire format the B7 kernel reads (0.25 B a base)."""
    packed = torch.from_numpy(_pack16_rows(bases).view(np.int32))
    return packed.to(device), torch.from_numpy(blens).to(device)


def read_survivor_arrays(px: ParsedFastx, c: int, k: int,
                         device: torch.device):
    """(read_ids, hashes) flat survivor arrays in (read, position) order,
    seeded on ``device`` (the B7 kernel and B8 repack on a CUDA device,
    their plain versions on the CPU).

    All batches dispatch first (packed 0.25 B/base up, condensed stream +
    per-read counts down), then fetch in a second pass, so device compute
    and transfers pipeline across batches. A batch whose condensed stream
    lost survivors (a window over its capacity: about 1e-9 a window) is
    redone without the condensation."""
    lengths = px.lengths
    parts_r: List[np.ndarray] = []
    parts_h: List[np.ndarray] = []
    pending = []

    def dispatch(bucket_len: int, rids: np.ndarray):
        packed, lens_d = _upload_batch(
            *_build_batch(px, bucket_len, rids), device)
        stream, n_r = _seed_packed(packed, lens_d, c, k, bucket_len)
        pending.append((bucket_len, rids, packed, lens_d, stream, n_r))

    max_b = _BUCKETS[-1]
    short = np.flatnonzero((lengths >= k) & (lengths <= max_b))
    if short.size:
        bucket_of = np.searchsorted(np.asarray(_BUCKETS), lengths[short],
                                    side="left")
        for bi, b in enumerate(_BUCKETS):
            sel = short[bucket_of == bi]
            for s in range(0, sel.size, _MAX_BATCH):
                dispatch(b, sel[s:s + _MAX_BATCH])

    for bucket_len, rids, packed, lens_d, stream, n_r in pending:
        nr_h = n_r.cpu().numpy()[:rids.size].astype(np.int64)
        s = stream.cpu().numpy()
        live = s != -1
        if int(live.sum()) != int(nr_h.sum()):
            rows = _seed_rows(packed, lens_d, c, k,
                              bucket_len).cpu().numpy()[:rids.size]
            lv = rows != -1
            rr = np.broadcast_to(rids[:, None], rows.shape)[lv]
            parts_r.append(rr.astype(np.int64))
            parts_h.append(rows[lv].view(np.uint64))
            continue
        parts_r.append(np.repeat(rids, nr_h))
        parts_h.append(s[live].view(np.uint64))

    for rid in np.flatnonzero(lengths > max_b).tolist():
        h = fmh_seeds_np(px.record_codes(rid), c, k)
        if h.size:
            parts_r.append(np.full(h.size, rid, np.int64))
            parts_h.append(h)
    if not parts_h:
        return np.empty(0, np.int64), np.empty(0, np.uint64)
    rids_all = np.concatenate(parts_r)
    hashes_all = np.concatenate(parts_h)
    # restore global (read, position) order; the stable sort keeps the
    # within-read position order each batch row preserved
    order = np.argsort(rids_all, kind="stable")
    return rids_all[order], hashes_all[order]


# ---------------------------------------------------------------------------
# genome seeding

_GBLOCK = 4096          # genome scan row length (bases)
_GROWS = 2048           # rows per device call


def _genome_rows(px: ParsedFastx, k: int):
    """(contig, offset, length) of every scan row: contig i of n >= k
    bases gives rows at offsets 0, step, 2*step, ... < n-k+1 with step =
    _GBLOCK-(k-1), each min(_GBLOCK, n - offset) bases long."""
    step = _GBLOCK - (k - 1)
    n = px.lengths.astype(np.int64)
    nrows = np.where(n >= k, (n - k) // step + 1, 0)
    cid = np.repeat(np.arange(px.n_records, dtype=np.int64), nrows)
    first = np.cumsum(nrows) - nrows
    off = (np.arange(cid.size, dtype=np.int64)
           - np.repeat(first, nrows)) * step
    return cid, off, np.minimum(_GBLOCK, n[cid] - off)


def genome_survivor_positions(px: ParsedFastx, c: int, k: int,
                              device: torch.device):
    """(contigs, end_positions, hashes) of FracMinHash survivors over all
    contigs, in (contig, position) order, seeded on ``device``: the device
    equivalent of fmh_seeds_positions per record (sylph
    src/seeding.rs:182-208), feeding the duplicate/spacing filter.

    Contigs scan in rows of _GBLOCK bases with a (k-1)-base halo, the
    seam-overlap trick of the reference's AVX2 lanes
    (src/avx2_seeding.rs:37-41) across rows. A batch of up to _GROWS rows
    is built with one strided gather, seeded by B7, compacted per row in
    position order (at most _row_cap survivors a row, as the JAX package
    keeps them), and fetched once as (row, lane, hash) triples. A row
    whose survivors reach the cap may have lost some: such rows are
    warned about, and the row counts go to a debug record."""
    W = _GBLOCK - k + 1
    cap = _row_cap(W, c)
    cid, off, rlen = _genome_rows(px, k)
    padded = np.concatenate([px.codes, np.zeros(_GBLOCK, np.uint8)])
    out_c, out_p, out_h = [], [], []
    at_cap = 0
    for s in range(0, cid.size, _GROWS):
        bc, bo = cid[s:s + _GROWS], off[s:s + _GROWS]
        packed, lens_d = _upload_batch(*_gather_rows(
            padded, px.starts[bc] + bo, rlen[s:s + _GROWS], _GBLOCK), device)
        hash_, keep = seed_packed(packed, lens_d, c=c, k=k)
        hrows, lanes = compact_by_position(hash_[:, :W], keep[:, :W], cap,
                                           want_lanes=True)
        row, col = (hrows != -1).nonzero(as_tuple=True)
        got = torch.stack([row, lanes[row, col], hrows[row, col]]).cpu()
        row, lane, h = got.numpy()
        if cap < W:           # at cap == W (c = 1) no survivor can be lost
            at_cap += int((np.bincount(row, minlength=bc.size) >= cap).sum())
        out_c.append(bc[row])
        # end position of the window, like fmh_seeds_positions
        out_p.append(bo[row] + lane + (k - 1))
        out_h.append(h.view(np.uint64))
    if at_cap:
        log.warning("%d genome rows reached the survivor cap of %d; "
                    "survivors past it are dropped", at_cap, cap)
    log.debug("[genome rows] %d rows, %d at the survivor cap", cid.size,
              at_cap, extra={"genome_rows": (int(cid.size), at_cap)})
    if not out_h:
        e = np.empty(0, np.int64)
        return e, e, np.empty(0, np.uint64)
    return (np.concatenate(out_c), np.concatenate(out_p),
            np.concatenate(out_h))


# ---------------------------------------------------------------------------
# streamed device-resident sample (grange serving path)

SEG_ENTRIES = 1 << 20


class DeviceSampleStream:
    """Accumulates first-insertion-order k-mers into fixed buffers of
    SEG_ENTRIES int64 keys during the host ingest and uploads each full
    buffer from an uploader thread, so the transfer never blocks the fold.
    push() is called from ONE thread (the fold chain is order-dependent).
    Host buffers are pinned on a CUDA device and allocated anew per flush,
    so a buffer is never refilled while its copy is in flight."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: List[torch.Tensor] = []
        self._pend = self._new_buffer()
        self._fill = 0
        self.total = 0
        self._err: List[BaseException] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=4)
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def _new_buffer(self) -> torch.Tensor:
        buf = torch.full((SEG_ENTRIES,), -1, dtype=torch.int64)
        return buf.pin_memory() if self.device.type == "cuda" else buf

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err:
                continue             # keep draining so push() never blocks
            try:
                self._bufs.append(item.to(self.device, non_blocking=True))
            except Exception as e:   # re-raised by finalize()
                self._err.append(e)

    def push(self, kmers_u64: np.ndarray) -> None:
        if kmers_u64.size == 0:
            return
        keys = np.ascontiguousarray(kmers_u64, np.uint64).view(np.int64)
        self.total += int(keys.size)
        pos = 0
        while pos < keys.size:
            take = min(SEG_ENTRIES - self._fill, keys.size - pos)
            self._pend.numpy()[self._fill:self._fill + take] = \
                keys[pos:pos + take]
            self._fill += take
            pos += take
            if self._fill == SEG_ENTRIES:
                self._q.put(self._pend)
                self._pend = self._new_buffer()
                self._fill = 0

    def close(self) -> None:
        """Stop the uploader thread without finalizing (an abandoned
        stream: the sketch failed)."""
        if self._worker.is_alive():
            self._q.put(None)
            self._worker.join()

    def finalize(self, kmers: np.ndarray, counts: np.ndarray):
        """-> DeviceSampleView of the finished sketch, or None when nothing
        was streamed (an empty sketch). A stream that disagrees with the
        sketch is a fault and raises."""
        if self._fill:
            self._q.put(self._pend)
            self._fill = 0
        self.close()
        if self._err:
            raise self._err[0]
        if self.total != kmers.size:
            raise RuntimeError(f"device sample stream out of sync: "
                               f"{self.total} streamed, {kmers.size} "
                               "sketched")
        if self.total == 0:
            return None
        wq = np.minimum(counts, 63).astype(np.uint8)
        exc = np.flatnonzero(wq != 1)
        if exc.size <= max(1024, self.total // 8):
            # almost every k-mer has multiplicity 1: ship only the
            # exceptions and build the weights on the device
            w_spec = ("sparse", exc.astype(np.int64), wq[exc].copy())
        else:
            w_spec = ("dense", wq)
        return DeviceSampleView(self.device, self._bufs, w_spec, self.total)


class DeviceSampleView:
    """Device-resident unsorted sample: SEG_ENTRIES-key buffers in
    first-insertion order (the last one padded with -1) plus a weight spec
    (sparse exception list or dense uint8 counts); consumed by
    GRangeEngine.hists(device_view=...) and candidate_mask_stream."""

    def __init__(self, device, bufs, w_spec, n: int):
        self.device = device
        self.bufs = bufs
        self.w_spec = w_spec
        self.n = n

    def live(self):
        """(keys int64 [n], weights uint8 [n]) on the device: the
        buffers concatenated and cut to the n live keys (the counterpart of
        the JAX padded_to_pow2, which pads instead to keep compile shapes
        stable; here the pads never enter the sort)."""
        keys = torch.cat(self.bufs)[:self.n]
        if self.w_spec[0] == "sparse":
            _, idx, vals = self.w_spec
            w = _w_build(self.n, idx, vals, self.device)
        else:
            w = torch.from_numpy(self.w_spec[1]).to(self.device)
        return keys, w


def _w_build(n: int, idx: np.ndarray, vals: np.ndarray,
             device: torch.device) -> torch.Tensor:
    """[n] uint8 weights: 1 everywhere but the exception positions. Every
    index is below n (the spec holds no pad entries), so the scatter needs
    no drop mode."""
    w = torch.ones(n, dtype=torch.uint8, device=device)
    if idx.size:
        w[torch.from_numpy(idx).to(device)] = torch.from_numpy(vals).to(
            device)
    return w
