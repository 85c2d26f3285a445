"""Several devices and processes, checked end to end (counterpart of
__graft_entry__.py::dryrun_multichip and _dryrun_grange, and of the worker
of tests/multiproc_worker.py), and ``entry()``, the one-device compile
check of __graft_entry__.py::entry.

    python -m sylph_tpu_torch.multichip dryrun N [--device cuda|cpu]

``dryrun_multichip(N)`` runs the sharded one-shot step
(gpu/pipeline.py::make_sharded_profile_step) on N ranks, NCCL ranks on N
GPUs (the default; it raises with fewer) or, with ``--device cpu``, gloo
processes on the CPU, and holds its histogram integer for integer (and its
naive ANI within rtol 1e-5) against the one-device ``profile_step``; then the grange dry run: the engine on N
devices (heavy runs and forced spill in the index) against the same engine
on one device and a numpy searchsorted oracle, and two process spans whose
partial histograms sum to the oracle.

    python -m sylph_tpu_torch.multichip worker MODE --address HOST:PORT \
        --world N --rank I [options] [-- CLI ARGS]

is one rank of a group, started by ``run_ranks``: ``step`` (the sharded
step on built-in example data or on the arrays of ``--data DIR``, each
rank writing its histogram, statistics, launch counts and seconds to
``OUT.rank<I>.npz``) and ``grange`` (two processes' partial histograms of
one index merged over the group, rank 0 writing ``OUT``), both on cuda
unless ``--device cpu`` is given, and ``cli`` (``cli.main(CLI ARGS)``,
which takes its device and joins the group through its own flags; ``--grange-min`` and ``--chunk-slots`` lower the
grange threshold and chunk size, as tests do to put a small database in
the grange regime; ``--report FILE`` writes the call's wall, stage
records, kernel launches and peak device memory as JSON).
"""

import argparse
import functools
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .gpu.containment import build_host_index
from .gpu.grange import (GRangeEngine, build_grange_index,
                         merge_process_hists)
from .gpu.keys import HIST_H
from .kmer.seeding import fmh_seeds_np
from .utils.distributed import init_group, shutdown

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- processes -------------------------------------------------------------

def free_port() -> int:
    """A TCP port the OS reports free on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argvs: Sequence[List[str]], timeout_s: float,
              stdin: Optional[bytes] = None, env: Optional[dict] = None):
    """Start one process per argv (``python ARGV``), all together, and wait
    for every one within ``timeout_s`` of the start; past it every process
    still running is killed and TimeoutError raised. ``stdin`` goes to each.
    Returns [(returncode, stdout, stderr)] in argv order."""
    e = dict(os.environ if env is None else env)
    e["PYTHONPATH"] = os.pathsep.join(
        [_PKG_PARENT] + [p for p in [e.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen([sys.executable, *argv], env=e,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for argv in argvs]
    out = [None] * len(procs)

    def talk(i):            # every rank's pipes at once: ranks wait on
        so, se = procs[i].communicate(input=stdin)    # one another
        out[i] = (procs[i].returncode, so.decode(errors="replace"),
                  se.decode(errors="replace"))
    threads = [threading.Thread(target=talk, args=(i,), daemon=True)
               for i in range(len(procs))]
    deadline = time.monotonic() + timeout_s
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"{len(procs)} ranks did not finish within "
                               f"{timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in threads:
            t.join(10.0)
    return out


def worker_argv(mode: str, address: str, world: int, rank: int,
                *options: str) -> List[str]:
    return ["-m", "sylph_tpu_torch.multichip", "worker", mode, "--address",
            address, "--world", str(world), "--rank", str(rank), *options]


def _check_ranks(results, what: str) -> None:
    for r, (rc, _so, se) in enumerate(results):
        if rc != 0:
            raise RuntimeError(f"{what}: rank {r} exited {rc}:\n{se[-3000:]}")


# ---- data ------------------------------------------------------------------

def example_data(n_reads: int, read_len: int, kmers_per_genome: int,
                 n_genomes: int, c: int, k: int, pad_multiple: int = 8,
                 seed: int = 0, var_sizes: bool = False):
    """(bases [N, L] uint32 2-bit codes, lengths [N] int32, HostIndex) of
    __graft_entry__.py::_example_data: random reads, and genomes half drawn
    from the first 64 reads' surviving hashes (so containment is nonzero),
    half random below the FracMinHash bound; ``var_sizes`` makes genome
    sizes strongly uneven, so shard boundaries cut genomes."""
    rng = np.random.default_rng(seed)
    codes = np.frombuffer(b"ACGT", dtype=np.uint8)
    bases = rng.integers(0, 4, size=(n_reads, read_len)).astype(np.uint32)
    lengths = np.full(n_reads, read_len, np.int32)
    seqs = codes[bases[:min(n_reads, 64)].astype(np.int64)]
    pool = [fmh_seeds_np(row.tobytes(), c, k) for row in seqs]
    pool = np.concatenate(pool) if pool else np.empty(0, np.uint64)
    thr = ((1 << 64) - 1) // c
    genomes = []
    for _ in range(n_genomes):
        kpg = kmers_per_genome
        if var_sizes:
            kpg = int(rng.integers(kmers_per_genome // 4,
                                   2 * kmers_per_genome))
        n_own = min(kpg // 2, pool.size)
        own = (rng.choice(pool, size=n_own, replace=False)
               if n_own else np.empty(0, np.uint64))
        rand = rng.integers(0, thr, size=kpg - n_own, dtype=np.uint64)
        genomes.append(np.concatenate([own, rand]))
    return bases, lengths, build_host_index(genomes,
                                            pad_multiple=pad_multiple)


GRANGE_GENOMES = 40
GRANGE_BUILD = dict(target_mean=256, ci_cap=256, heavy_run=8)


def grange_world(chunk_slots: int, n_chunks: int):
    """The grange dry run's data (__graft_entry__.py:133-160): (kmers
    uint64, gids int32 below GRANGE_GENOMES, sorted unique sample kmers,
    their counts). A slab of hashes is shared across many genomes
    (GTDB-style duplication), so GRANGE_BUILD's ``heavy_run=8`` moves runs
    to the CSR and its ``ci_cap=256`` forces spill."""
    rng = np.random.default_rng(3)
    thr = ((1 << 64) - 1) // 20
    m = chunk_slots * n_chunks
    kmers = rng.integers(0, thr, size=m, dtype=np.uint64)
    ndup = m // 8
    kmers[:ndup] = rng.choice(kmers[ndup:ndup + 64], size=ndup)
    gids = rng.integers(0, GRANGE_GENOMES, size=m).astype(np.int32)
    sk = np.unique(np.concatenate([
        rng.choice(kmers, size=3_000),
        rng.integers(0, thr, size=3_000, dtype=np.uint64)]))
    sc = rng.integers(1, 100, size=sk.size).astype(np.uint32)
    return kmers, gids, sk, sc


def oracle_hists(kmers, gids, n_genomes: int, sk, sc) -> np.ndarray:
    """[G, 64] histograms by searchsorted of every (kmer, gid) pair into
    the sorted sample (the dry run's numpy oracle)."""
    want = np.zeros((n_genomes, HIST_H), np.int64)
    idx = np.searchsorted(sk, kmers)
    idxc = np.minimum(idx, sk.size - 1)
    cts = np.where((idx < sk.size) & (sk[idxc] == kmers), sc[idxc], 0)
    live = cts > 0
    np.add.at(want, (gids[live], np.minimum(cts[live], HIST_H - 1)), 1)
    return want


def _step_example(name: str, dp: int, ip: int):
    """(bases, lengths, HostIndex, step kwargs) of a built-in example:
    "dryrun" (__graft_entry__.py:68-130: 64 genomes of uneven size, >= 10^5
    index k-mers, 32 reads a dp rank) or "multiproc" (the data of
    tests/test_multiprocess.py::test_two_process_profile)."""
    if name == "dryrun":
        c, k, G = 50, 31, 64
        bases, lengths, idx = example_data(
            32 * dp, 128, 2048, G, c, k, pad_multiple=8 * dp * ip,
            var_sizes=True)
        return bases, lengths, idx, dict(c=c, k=k, n_genomes=G,
                                         n_buckets=32, min_ani=0.5)
    if name == "multiproc":
        rng = np.random.default_rng(0)
        c, k, G = 20, 31, 4
        bases = rng.integers(0, 4, size=(32, 64)).astype(np.uint32)
        lengths = np.full(32, 64, np.int32)
        thr = ((1 << 64) - 1) // c
        genomes = [rng.integers(0, thr, size=100, dtype=np.uint64)
                   for _ in range(G)]
        return bases, lengths, build_host_index(genomes, pad_multiple=64), \
            dict(c=c, k=k, n_genomes=G, n_buckets=32, min_ani=0.0)
    raise ValueError(f"unknown example {name!r}")


def save_step_data(path: str, bases: np.ndarray, lengths: np.ndarray,
                   idx_key: np.ndarray, gids: np.ndarray, n_kmers: np.ndarray,
                   **kw) -> None:
    """Write a step's inputs for ``worker step --data``: ``bases`` [B, N, L]
    (B batches of N reads) or [N, L], the index arrays, and the step's
    keyword arguments (c, k, n_genomes, n_buckets, min_ani)."""
    os.makedirs(path, exist_ok=True)
    for name, a in (("bases", bases), ("lengths", lengths),
                    ("idx_key", idx_key), ("gids", gids),
                    ("n_kmers", n_kmers)):
        np.save(os.path.join(path, f"{name}.npy"), a)
    with open(os.path.join(path, "step.json"), "w") as f:
        json.dump(kw, f)


def _load_step_data(path: str, dp: int):
    """``save_step_data``'s arrays, batches [B, N, L] laid out so that dp
    rank d's contiguous block of rows holds the d-th part of every batch."""
    ld = {n: np.load(os.path.join(path, f"{n}.npy")) for n in (
        "bases", "lengths", "idx_key", "gids", "n_kmers")}
    with open(os.path.join(path, "step.json")) as f:
        kw = json.load(f)
    b, n = ld["bases"], ld["lengths"]
    if b.ndim == 3:
        B, N, L = b.shape
        b = np.ascontiguousarray(b.reshape(B, dp, N // dp, L).transpose(
            1, 0, 2, 3)).reshape(-1, L)
        n = np.ascontiguousarray(n.reshape(B, dp, N // dp).transpose(
            1, 0, 2)).reshape(-1)
    return b, n, ld["idx_key"], ld["gids"], ld["n_kmers"], kw


# ---- workers ---------------------------------------------------------------

def _step_worker(a) -> None:
    import torch.distributed as dist

    from .gpu import _cuda
    from .gpu.pipeline import (make_mesh, make_sharded_profile_step,
                               profile_step)
    init_group(a.address, a.world, a.rank, backend=a.backend)
    try:
        mesh = make_mesh(a.world, dp=a.dp, device=a.device)
        dp, ip = mesh.mesh.shape
        if a.data:
            bases, lengths, ikey, gids, nk, kw = _load_step_data(a.data, dp)
        else:
            bases, lengths, idx, kw = _step_example(a.example, dp, ip)
            ikey, gids, nk = idx.keys, idx.genome_ids, idx.n_kmers
        fn = make_sharded_profile_step(mesh, **kw)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
        _cuda.reset_launches()
        t0 = time.perf_counter()
        hist, st = fn(bases, lengths, ikey, gids, nk)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
               else 0)
        np.savez(f"{a.out}.rank{a.rank}.npz", hist=hist.cpu().numpy(),
                 launches=json.dumps(launches), wall_s=wall,
                 max_memory_allocated=mem, backend=dist.get_backend(),
                 dp=dp, ip=ip, **{f: getattr(st, f).cpu().numpy()
                                  for f in st._fields})
        if a.check and a.rank == 0:
            # the one-device oracle: the same batch through profile_step
            h0, st0 = profile_step(bases, lengths, ikey, gids, nk,
                                   device=dev, **kw)
            h, h0 = hist.cpu().numpy(), h0.cpu().numpy()
            if not (h == h0).all():
                raise SystemExit(f"sharded histogram diverges from the "
                                 f"one-device step: {np.abs(h - h0).sum()}"
                                 " total count error")
            if not h[:, 1:].sum() > 0:
                raise SystemExit("the sharded step matched nothing")
            np.testing.assert_allclose(st.naive_ani.cpu().numpy(),
                                       st0.naive_ani.cpu().numpy(),
                                       rtol=1e-5)
    finally:
        shutdown()


def _grange_worker(a) -> None:
    """tests/multiproc_worker.py::grange_main: this process's partial
    histogram over its chunks of the dry run's index, merged over the
    group; rank 0 writes the merged histogram to ``OUT``."""
    init_group(a.address, a.world, a.rank)
    try:
        kmers, gids, sk, sc = grange_world(a.chunk_slots or 1 << 14, 4)
        gidx = build_grange_index(kmers, gids, GRANGE_GENOMES,
                                  chunk_slots=a.chunk_slots or 1 << 14,
                                  device=a.device, **GRANGE_BUILD)
        if len(gidx.chunk_keys) < a.world:
            raise SystemExit("fewer chunks than processes")
        eng = GRangeEngine(gidx, devices=[a.device],
                           process_span=(a.rank, a.world))
        merged = merge_process_hists(eng.partial_hists(sk, sc))
        if a.rank == 0:
            np.save(a.out, merged)
    finally:
        shutdown()


class _StageRecords(logging.Handler):
    """The stage_timer records of a run: [(stage, seconds)] in order."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.items = []

    def emit(self, rec):
        if isinstance(rec.msg, str) and rec.msg.startswith("[timing] %s:"):
            self.items.append((str(rec.args[0]), float(rec.args[1])))


def _cli_worker(a, argv: List[str]) -> int:
    """cli.main(argv); with ``--report FILE`` the call's exit code, wall
    seconds, stage records, kernel launches and peak device memory go to
    FILE as JSON."""
    from . import cli
    from .engine import device_exec
    from .gpu import _cuda
    if a.grange_min is not None:
        device_exec.DeviceContainment.GRANGE_MIN = a.grange_min
    if a.chunk_slots:
        device_exec.build_grange_index = functools.partial(
            build_grange_index, chunk_slots=a.chunk_slots)
    stages = _StageRecords()
    logging.getLogger("sylph").addHandler(stages)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if a.report:
        with open(a.report, "w") as f:
            json.dump(dict(
                rc=rc, wall_s=wall, stages=stages.items,
                launches={k: v for k, v in _cuda.LAUNCHES.items() if v},
                max_memory_allocated=torch.cuda.max_memory_allocated()
                if cuda else 0), f)
    return rc


# ---- the dry run -----------------------------------------------------------

def _dryrun_grange(devices: List[torch.device],
                   chunk_slots: int = 1 << 15) -> None:
    """The grange regime on ``devices`` (__graft_entry__.py:133-200): at
    least one chunk a device, heavy runs and spill in the index; the
    all-device histogram equals the one-device engine's and the numpy
    oracle, and two process spans' partials sum to the oracle."""
    G = GRANGE_GENOMES
    kmers, gids, sk, sc = grange_world(chunk_slots, max(2, len(devices)))
    gidx = build_grange_index(kmers, gids, G, chunk_slots=chunk_slots,
                              device=devices[0], **GRANGE_BUILD)
    if len(gidx.chunk_keys) < min(len(devices), 2) or not gidx.n_heavy:
        raise AssertionError("the dry run's index lacks chunks or heavy runs")
    want = oracle_hists(kmers, gids, G, sk, sc)
    h_multi = GRangeEngine(gidx, devices=devices).hists(sk, sc)
    h_one = GRangeEngine(gidx, devices=devices[:1]).hists(sk, sc)
    if not (h_multi == h_one).all():
        raise AssertionError(
            f"multi-device grange histogram diverges from one device: "
            f"{np.abs(h_multi - h_one).sum()} total count error")
    if not (h_multi == want).all():
        raise AssertionError(
            f"grange histogram diverges from the numpy oracle: "
            f"{np.abs(h_multi - want).sum()} total count error")
    if not h_multi[:, 1:].sum() > 0:
        raise AssertionError("the grange dry run matched nothing")
    half = max(1, len(devices) // 2)
    p0 = GRangeEngine(gidx, devices=devices[:half],
                      process_span=(0, 2)).hists(sk, sc)
    p1 = GRangeEngine(gidx, devices=devices[half:] or devices[:1],
                      process_span=(1, 2)).hists(sk, sc)
    if not (p0 + p1 == want).all():
        raise AssertionError(
            f"process-span partial histograms do not sum to the oracle: "
            f"{np.abs(p0 + p1 - want).sum()} total count error")


def entry(device="cuda"):
    """(fn, args) of the one-device compile check (__graft_entry__.py:
    51-66): ``fn(*args)`` runs gpu/pipeline.py::profile_step on 256 reads
    of 128 bases against 8 genomes x 512 k-mers (c = 50, k = 31) and
    returns (hist [8, 64], final_ani, final_cov); ``args`` are on
    ``device`` (the default ``cuda`` raises without a GPU)."""
    from .gpu.grange import resolve_device
    from .gpu.pipeline import profile_step

    dev = resolve_device(device)
    c, k, G = 50, 31, 8
    bases, lengths, idx = example_data(256, 128, 512, G, c=c, k=k)

    def forward(bases, lengths, idx_key, gids, n_kmers):
        hist, st = profile_step(bases, lengths, idx_key, gids, n_kmers, c=c,
                                k=k, n_genomes=G, n_buckets=64, min_ani=0.5,
                                device=dev)
        return hist, st.final_ani, st.final_cov

    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (bases.astype(np.uint8), lengths, idx.keys,
                           idx.genome_ids, idx.n_kmers))
    return forward, args


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout_s: float = 600.0) -> None:
    """The sharded step on ``n_devices`` ranks against the one-device step,
    then the grange dry run on ``n_devices`` devices (module docstring).
    ``cuda`` (the default): NCCL ranks, one a GPU (raises with fewer
    GPUs); ``cpu``, when asked for: gloo processes on the CPU. Raises on
    any disagreement."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"need {n_devices} GPUs, have "
                               f"{torch.cuda.device_count()}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
        backend = "nccl"
    else:
        devices = [torch.device("cpu")] * n_devices
        backend = "gloo"
    address = f"127.0.0.1:{free_port()}"
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks([worker_argv(
            "step", address, n_devices, r, "--backend", backend, "--device",
            dev.type, "--example", "dryrun", "--check", "--out",
            os.path.join(tmp, "step")) for r in range(n_devices)],
            timeout_s)
    _check_ranks(res, "sharded step")
    _dryrun_grange(devices)


# ---- command line ----------------------------------------------------------

def _parser():
    ap = argparse.ArgumentParser(prog="python -m sylph_tpu_torch.multichip",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dryrun", help="dryrun_multichip(N)")
    d.add_argument("n", type=int)
    d.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    w = sub.add_parser("worker", help="one rank of a group (run_ranks)")
    w.add_argument("mode", choices=("step", "grange", "cli"))
    w.add_argument("--address", required=True)
    w.add_argument("--world", type=int, required=True)
    w.add_argument("--rank", type=int, required=True)
    w.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    w.add_argument("--device", default="cuda")
    w.add_argument("--dp", type=int, default=None)
    w.add_argument("--example", choices=("dryrun", "multiproc"),
                   default="dryrun")
    w.add_argument("--data", default=None)
    w.add_argument("--check", action="store_true")
    w.add_argument("--out", default=None)
    w.add_argument("--grange-min", dest="grange_min", type=int, default=None)
    w.add_argument("--chunk-slots", dest="chunk_slots", type=int,
                   default=None)
    w.add_argument("--report", default=None)
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    rest = []
    if "--" in argv:
        i = argv.index("--")
        argv, rest = argv[:i], argv[i + 1:]
    a = _parser().parse_args(argv)
    if a.cmd == "dryrun":
        dryrun_multichip(a.n, a.device)
        print(f"dryrun_multichip({a.n}, {a.device!r}): ok")
        return 0
    if a.mode == "step":
        _step_worker(a)
    elif a.mode == "grange":
        _grange_worker(a)
    else:
        return _cli_worker(a, rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
