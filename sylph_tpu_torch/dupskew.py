"""Duplication skew of the grange layout, flat (nt=1) against hash-tiled
(nt=4) (counterpart of scripts/dupskew.py).

Real databases duplicate k-mers ACROSS genomes: a conserved 31-mer shared
by d genomes occupies d index slots at the SAME hash value: one bucket and,
under the tiled layout (nt>1), one hash sub-range tile. Tiles are sized at
the sub-range mean, so duplication runs eat tile and shared overflow
capacity and then spill to the host-probed overflow list; nt=1 buckets
absorb the same runs until ci_cap; runs longer than the heavy-run threshold
become one marker slot and a CSR of genome ids. This tool measures that
trade-off, which gates the CLI's nt default (gpu/grange.py's choice of nt=4
when the fullest chunk's per-bucket mean is at least 896):

  for each duplication profile (zipf exponent x max-dup cap):
    build the nt=1 and nt=4 layouts over the same (kmer, gid) index
    (gpu/grange.py::build_grange_index) and report spill fraction, CI, the
    compares an index lane does (nt=1: CI, nt=4: tile+ov), the layout's
    device bytes and build seconds, then hold the engine's histograms of
    a planted sample against a brute-force oracle: ``parity`` through
    GRangeEngine.hists (the host-sorted table), ``dparity`` through
    hist_device_stream on the sample's occurrence stream (int64 keys in
    uint64 order, padded with -1 to a power of two, folded on the device),
    its markers expanded and spill added, timed over 3 runs.

The stream sweep sizes its cell and code capacities from the sample's mean
per chunk, as the engine's one-fetch sweep does; that mean stands for every
chunk when the chunks are many and full, as at GTDB scale (22 chunks), and
where one or two chunks take unequal shares its probe fails (production
callers then take the per-chunk path). So every layout must hold at least
``MIN_CHUNKS`` (8) chunks, all but the last full; ``run`` raises before it
times a layout with fewer. Each chunk's buckets sit at the GTDB chunks'
mean of 1,024 slots.

The defaults are the GTDB chunk geometry (2^25-slot chunks of 32,768
buckets) with the uniform profile's index exactly 8 chunks (``--unique``
2^28). A skewed profile at the same ``--unique`` holds sum(d) entries on
the host (4.6x, 7.7x and 243x the unique count for a2.0:d1000, a1.5:d100
and a1.2:d5000) and fills more chunks (runs longer than 16 keep one
marker slot: about 2.1 and 2.9 slots a unique k-mer for the first two), so
give it its own smaller ``--unique`` that still fills 8 chunks, e.g.
``--profiles a2.0:d1000 --unique 1.36e8``. a1.2:d5000 cannot fill 8 such
chunks in a host's memory: run it with a smaller ``--chunk-slots``.

``hbm`` is the port's own resident bytes: the chunk key grids (int64) and
genome-id grids (int32). The JAX tool's ``chunk_hi.nbytes * 3`` counts its
u32 hi/lo/gid planes, which the port does not have.

    python -m sylph_tpu_torch.dupskew [--unique 268435456] [--genomes 25000]
        [--profiles uniform] [--nt 1,4] [--sample 2e6]
        [--chunk-slots 33554432] [--device cuda|cpu]

e.g. the JAX tool's four profiles at a card-test cut: ``--profiles
uniform,a2.0:d1000,a1.5:d100,a1.2:d5000 --unique 131072 --chunk-slots
16384 --sample 5e4`` (the uniform index in 8 full chunks of 16 buckets).

Every line must show ``parity=OK dparity=OK``; a FAIL exits non-zero.
"""

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from .gpu.grange import GRangeEngine, build_grange_index, resolve_device

C = 200
K = 31
PROFILES = "uniform,a2.0:d1000,a1.5:d100,a1.2:d5000"   # the JAX tool's
MIN_CHUNKS = 8


def _sorted_unique(a: np.ndarray, device) -> np.ndarray:
    """np.unique of uint64 values below 2^63 (their int64 order is their
    uint64 order), sorted by torch on ``device``: on some hosts numpy's
    sort of 2^28 random keys takes minutes."""
    s = torch.sort(torch.from_numpy(a.view(np.int64)).to(device)).values
    keep = torch.ones_like(s, dtype=torch.bool)
    keep[1:] = s[1:] != s[:-1]
    return s[keep].cpu().numpy().view(np.uint64)


def _run_heads(km: np.ndarray) -> np.ndarray:
    """np.unique of a sorted array, in one pass."""
    keep = np.ones(km.size, bool)
    np.not_equal(km[1:], km[:-1], out=keep[1:])
    return km[keep]


def gen_dup_index(n_unique: int, n_genomes: int, alpha: float,
                  max_dup: int, seed: int = 0, device="cpu"):
    """(kmers_u64 [m], gids [m], d [unique]) with zipf-distributed
    cross-genome duplication: hash i appears in d_i distinct genomes,
    P(d) ~ d^-alpha on [1, max_dup]. alpha<=0 -> no duplication. The same
    bytes as the JAX tool's for the same arguments; the unique draw is
    sorted on ``device``."""
    rng = np.random.default_rng(seed)
    thr = (1 << 64) // C
    uniq = rng.integers(0, thr, size=n_unique, dtype=np.uint64)
    uniq = _sorted_unique(uniq, device)
    if alpha <= 0:
        gids = rng.integers(0, n_genomes, size=uniq.size).astype(np.int32)
        return uniq, gids, np.ones(uniq.size, np.int64)
    d_vals = np.arange(1, max_dup + 1, dtype=np.float64)
    p = d_vals ** (-alpha)
    p /= p.sum()
    d = rng.choice(np.arange(1, max_dup + 1), size=uniq.size, p=p)
    km = np.repeat(uniq, d)
    # distinct genomes per duplicated hash: offset strides are enough for
    # layout statistics (the layout only sees gid != gid, not identity)
    base_g = rng.integers(0, n_genomes, size=uniq.size)
    off = np.arange(km.size) - np.repeat(np.cumsum(d) - d, d)
    gids = ((np.repeat(base_g, d) + off) % n_genomes).astype(np.int32)
    order = np.argsort(km, kind="stable")
    return km[order], gids[order], d


def layout_stats(kmers, gids, n_genomes, nt, device="cpu",
                 chunk_slots: int = 1 << 25):
    """(the layout, its statistics): nt, CI, tile, ov, spilled slots and
    their share, the compares an index lane does, the device bytes of its
    grids and the build's seconds."""
    t0 = time.perf_counter()
    gidx = build_grange_index(kmers, gids, n_genomes, nt=nt,
                              chunk_slots=chunk_slots, device=device)
    dt = time.perf_counter() - t0
    m = kmers.size
    spill = int(gidx.spill_kmers.size)
    lane = (gidx.tile + gidx.ov) if gidx.nt > 1 else gidx.CI
    hbm = sum(k.nbytes + g.nbytes
              for k, g in zip(gidx.chunk_keys, gidx.chunk_gid))
    return gidx, dict(nt=gidx.nt, CI=gidx.CI, tile=gidx.tile, ov=gidx.ov,
                      spill=spill, spill_frac=spill / max(m, 1), lane=lane,
                      hbm_gb=hbm / 1e9, build_s=dt, heavy=gidx.n_heavy)


def host_hist(kmers, gids, n_genomes, skm, sct, H=64):
    """Brute-force [G, H] oracle."""
    idx = np.searchsorted(skm, kmers)
    idxc = np.minimum(idx, max(skm.size - 1, 0))
    found = (idx < skm.size) & (skm[idxc] == kmers)
    cts = np.where(found, sct[idxc], 0).astype(np.int64)
    live = cts > 0
    seg = gids[live].astype(np.int64) * H + np.minimum(cts[live], H - 1)
    return np.bincount(seg, minlength=n_genomes * H).reshape(n_genomes, H)


def _occurrence_stream(skm: np.ndarray, sct: np.ndarray, dev):
    """The sample as an occurrence stream: each key repeated by its count,
    int64 bit patterns in uint64 order, -1 pads to a power of two."""
    occ = np.repeat(skm, sct)
    T = 1 << int(np.ceil(np.log2(max(occ.size, 1))))
    keys = np.full(T, -1, np.int64)
    keys[:occ.size] = occ.view(np.int64)
    return torch.from_numpy(keys).to(dev), int(occ.size)


def _parse_profile(prof: str):
    if prof == "uniform":
        return 0.0, 1
    a, d = prof.split(":")
    return float(a[1:]), int(d[1:])


def run(n_unique: int = 1 << 28, n_genomes: int = 25_000,
        profiles="uniform", nts=(1, 4), sample_n: int = 2_000_000,
        chunk_slots: int = 1 << 25, device="cuda", reps: int = 3) -> list:
    """One record per (profile, nt); raises ValueError on a layout of
    fewer than MIN_CHUNKS chunks, and RuntimeError unless every parity and
    dparity is OK."""
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    out, failed = [], []
    for prof in profiles.split(","):
        alpha, dmax = _parse_profile(prof)
        km, gg, d = gen_dup_index(n_unique, n_genomes, alpha, dmax,
                                  device=dev)
        uk = _run_heads(km)                   # km is sorted
        print(f"\n== profile {prof}: m={km.size} unique={uk.size}"
              f" mean_dup={km.size / max(uk.size, 1):.2f}"
              f" max_dup={int(d.max())}", flush=True)
        # planted sample: half hits (unique index hashes), half misses
        hit = (rng.choice(uk, size=sample_n // 2, replace=False)
               if uk.size >= sample_n // 2 else uk)
        miss = rng.integers(0, (1 << 64) // C, size=sample_n // 2,
                            dtype=np.uint64)
        skm = np.unique(np.concatenate([hit, miss]))
        sct = rng.integers(1, 8, size=skm.size).astype(np.uint32)
        oracle = host_hist(km, gg, n_genomes, skm, sct)
        n_match = int(oracle.sum())
        keys_d, n_occ = _occurrence_stream(skm, sct, dev)
        for nt in nts:
            gidx, st = layout_stats(km, gg, n_genomes, nt, dev, chunk_slots)
            if len(gidx.chunk_keys) < MIN_CHUNKS:
                raise ValueError(
                    f"dupskew: {prof} at nt={nt} fills "
                    f"{len(gidx.chunk_keys)} chunks of {chunk_slots} slots; "
                    f"the stream sweep's sizing needs {MIN_CHUNKS} or more "
                    "(raise --unique or lower --chunk-slots)")
            eng = GRangeEngine(gidx, device=dev)
            t0 = time.perf_counter()
            h = eng.hists(skm, sct)
            st["join_ms"] = (time.perf_counter() - t0) * 1e3
            st["parity"] = "OK" if np.array_equal(h, oracle) else "FAIL"

            def stream():
                hd, probe, P = eng.hist_device_stream(keys_d,
                                                      n_matches=n_match)
                return hd, probe, P, float(hd.sum().item())
            hd, probe, P, _ = stream()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                stream()
                ts.append((time.perf_counter() - t0) * 1e3)
            pv = probe.cpu().numpy()
            hG = eng._fold_heavy(hd.cpu().numpy())    # markers expanded
            if gidx.spill_kmers.size:
                hG = hG + eng._spill_hist(skm, sct)
            okd = (int(pv[0]) == 0 and int(pv[1]) <= P
                   and np.array_equal(hG, oracle))
            st.update(stream_ms=min(ts), stream_runs_ms=ts,
                      dparity="OK" if okd else "FAIL", profile=prof,
                      hits=n_match, occurrences=n_occ,
                      chunks=len(gidx.chunk_keys))
            if not okd:
                st.update(probe=pv.tolist(), P=P,
                          bins_off=int((hG != oracle).sum()))
            print(f"  nt={st['nt']}: CI={st['CI']} tile={st['tile']} "
                  f"ov={st['ov']} lane={st['lane']} heavy={st['heavy']} "
                  f"spill={st['spill']} ({100 * st['spill_frac']:.3f}%) "
                  f"hbm={st['hbm_gb']:.2f}GB build={st['build_s']:.1f}s "
                  f"join={st['join_ms']:.0f}ms parity={st['parity']} "
                  f"stream={st['stream_ms']:.1f}ms "
                  f"runs={[round(t, 1) for t in ts]} "
                  f"dparity={st['dparity']}"
                  + ("" if okd else f" (probe {st['probe']}, P {P}, "
                     f"{st['bins_off']} bins off)"), flush=True)
            if st["parity"] != "OK" or st["dparity"] != "OK":
                failed.append((prof, st["nt"]))
            out.append(st)
            del eng, gidx, hd
        del keys_d
    if failed:
        raise RuntimeError(f"dupskew: parity FAIL in {failed}")
    return out


def main(argv: Optional[list] = None) -> int:
    if argv is None:
        from .cli import _tune_allocator
        _tune_allocator("sylph_tpu_torch.dupskew")
    ap = argparse.ArgumentParser(prog="python -m sylph_tpu_torch.dupskew",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--unique", type=float, default=1 << 28)
    ap.add_argument("--genomes", type=int, default=25_000)
    ap.add_argument("--profiles", default="uniform",
                    help=f"comma-separated; the JAX tool's: {PROFILES}")
    ap.add_argument("--nt", default="1,4")
    ap.add_argument("--sample", type=float, default=2e6)
    ap.add_argument("--chunk-slots", dest="chunk_slots", type=int,
                    default=1 << 25)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        from .gpu._cuda import card_line
        print(card_line(), flush=True)
    recs = run(int(a.unique), a.genomes, a.profiles,
               [int(x) for x in a.nt.split(",")], int(a.sample),
               a.chunk_slots, dev)
    print("dupskew: " + json.dumps(recs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
