"""The port across processes on the CPU: gloo groups of real processes
(``python -m sylph_tpu_torch.multichip worker ...``, each waited on with
its own timeout and killed past it), against the JAX package in this
process (tests/test_multiprocess.py's data and oracles):

- grange: two processes each sweep their half of the chunks and merge the
  [G, 64] int64 partials over the group; the merged histogram equals JAX's
  one-process engine and the numpy oracle;
- the sharded one-shot step: four ranks (dp = 2, ip = 2) give JAX's
  one-device ``profile_step`` histogram, integer for integer, on every rank;
- the CLI: two processes run ``profile`` and ``profile --serve`` with
  ``--coordinator`` on the o157 fixtures (64 decoy genomes beside them, so
  the grange sweep runs and merges); process 0's TSV equals the JAX host
  engine's and the port's one-process TSV, and process 1 writes nothing;
- ``dryrun_multichip(4)`` on the CPU;
- a coordinator that never answers fails within its timeout.
"""

import functools
import io
import os
import sys
import time

import numpy as np
import pytest
import torch

import sylph_tpu.tpu.grange as jgr
from sylph_tpu.tpu.pipeline import build_host_index as jax_host_index
from sylph_tpu.tpu.pipeline import profile_step as jax_profile_step
from sylph_tpu_torch import cli, multichip
from sylph_tpu_torch.engine import device_exec
from sylph_tpu_torch.engine.device_exec import DeviceContainment
from sylph_tpu_torch.gpu import grange as tgr
from sylph_tpu_torch.utils import distributed as ud
from tests.test_torch_multidevice import _jax_host_tsv, make_o157_world

torch.set_num_threads(1)
_TIMEOUT_S = 240          # each group of processes, killed past it
_ENV = dict(os.environ, OMP_NUM_THREADS="1")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ranks(mode, n, *options, cli_args=(), stdin=None):
    address = f"127.0.0.1:{multichip.free_port()}"
    argvs = [multichip.worker_argv(mode, address, n, r, *options)
             + ([] if not cli_args else
                ["--", *cli_args(r, address)]) for r in range(n)]
    res = multichip.run_ranks(argvs, _TIMEOUT_S, stdin=stdin, env=_ENV)
    for r, (rc, _so, se) in enumerate(res):
        assert rc == 0, f"rank {r} exited {rc}:\n{se[-3000:]}"
    return res


def test_two_process_grange(tmp_path):
    out = str(tmp_path / "merged.npy")
    _ranks("grange", 2, "--device", "cpu", "--out", out)
    merged = np.load(out)
    assert merged.dtype == np.int64
    kmers, gids, sk, sc = multichip.grange_world(1 << 14, 4)
    ref = jgr.build_grange_index(kmers, gids, 40, chunk_slots=1 << 14,
                                 **multichip.GRANGE_BUILD)
    assert ref.n_heavy > 0 and ref.spill_kmers.size > 0
    import jax
    full = jgr.GRangeEngine(ref, devices=[jax.devices()[0]]).hists(sk, sc)
    np.testing.assert_array_equal(merged, full)
    np.testing.assert_array_equal(
        merged, multichip.oracle_hists(kmers, gids, 40, sk, sc))
    assert merged[:, 1:].sum() > 0


def _jax_step_data(example):
    """The JAX side of multichip's examples: tests/test_multiprocess.py::
    test_two_process_profile's data, or __graft_entry__.py's dry run data
    at dp = ip = 2 (whose genomes hold the reads' hashes)."""
    if example == "dryrun":
        from __graft_entry__ import _example_data
        bases, lengths, idx = _example_data(
            n_reads=64, read_len=128, kmers_per_genome=2048, n_genomes=64,
            c=50, k=31, pad_multiple=32, var_sizes=True)
        return bases, lengths, idx, dict(c=50, k=31, n_genomes=64,
                                         n_buckets=32, min_ani=0.5)
    rng = np.random.default_rng(0)
    c, k, G = 20, 31, 4
    bases = rng.integers(0, 4, size=(32, 64)).astype(np.uint32)
    lengths = np.full(32, 64, np.int32)
    thr = ((1 << 64) - 1) // c
    genomes = [rng.integers(0, thr, size=100, dtype=np.uint64)
               for _ in range(G)]
    return bases, lengths, jax_host_index(genomes, pad_multiple=64), dict(
        c=c, k=k, n_genomes=G, n_buckets=32, min_ani=0.0)


@pytest.mark.parametrize("example", ["multiproc", "dryrun"])
def test_four_rank_sharded_step_matches_jax(tmp_path, example):
    out = str(tmp_path / "step")
    _ranks("step", 4, "--device", "cpu", "--example", example, "--dp", "2",
           "--out", out)
    bases, lengths, idx, kw = _jax_step_data(example)
    want, st = jax_profile_step(bases, lengths, idx.hi, idx.lo,
                                idx.genome_ids, idx.n_kmers, **kw)
    want = np.asarray(want)
    # every index k-mer lands in one bin; the dry run's also match reads
    assert want.sum() == int(idx.n_kmers.sum())
    assert (want[:, 1:].sum() > 0) == (example == "dryrun")
    for r in range(4):
        got = np.load(f"{out}.rank{r}.npz")
        assert (int(got["dp"]), int(got["ip"])) == (2, 2)
        assert str(got["backend"]) == "gloo"
        np.testing.assert_array_equal(got["hist"], want)
        np.testing.assert_allclose(got["naive_ani"],
                                   np.asarray(st.naive_ani), rtol=1e-5)


@pytest.fixture(scope="module")
def o157(tmp_path_factory):
    d = tmp_path_factory.mktemp("o157mp")
    make_o157_world(d)
    return d


_CLI_PATCH = ("--grange-min", str(1 << 12), "--chunk-slots", str(1 << 13))


def _one_process_tsv(argv, monkeypatch, tmp_path, stdin=None):
    """The port's TSV of the same call in this process, with the same
    patches (tests/multiproc_worker.py:cli_main's)."""
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 1 << 12)
    monkeypatch.setattr(device_exec, "build_grange_index", functools.partial(
        tgr.build_grange_index, chunk_slots=1 << 13))
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    out = tmp_path / "one.tsv"
    assert cli.main([*argv, "--device", "cpu", "-t", "2", "-o",
                     str(out)]) == 0
    return out.read_text()


def _two_process_cli(argv, tmp_path, stdin=None):
    """Process i runs ``argv --coordinator ... --process-id i -o outi.tsv``;
    returns (process 0's TSV, the ranks' results)."""
    outs = [tmp_path / f"out{i}.tsv" for i in range(2)]
    res = _ranks("cli", 2, *_CLI_PATCH, cli_args=lambda r, addr: [
        *argv, "--device", "cpu", "-t", "2", "-o", str(outs[r]),
        "--coordinator", addr, "--num-processes", "2", "--process-id",
        str(r), "--debug"], stdin=stdin)
    assert not outs[1].exists()           # process 1 writes nothing
    assert res[1][1] == ""
    for _rc, _so, se in res:
        assert "process hists merge" in se     # the sweep merged
        assert "Containment runs on 1 device(s) (cpu), process" in se
    return outs[0].read_text(), res


def test_two_process_cli_profile(o157, tmp_path, monkeypatch):
    files = [str(o157 / "db.syldb"), str(o157 / "sample.sylsp")]
    got, _res = _two_process_cli(["profile", *files], tmp_path)
    want = _jax_host_tsv(files)
    assert got == want
    assert len(got.splitlines()) >= 2
    assert got == _one_process_tsv(["profile", *files], monkeypatch,
                                   tmp_path)


def test_two_process_cli_serve(o157, tmp_path, monkeypatch):
    """--serve with two request lines fed to both processes: a sketch,
    then raw reads (sketched in each process, swept without a device
    view). Process 0's rows are the host engine's, request by request."""
    db, smp = str(o157 / "db.syldb"), str(o157 / "sample.sylsp")
    reads = os.path.join(_REPO, "test_files", "o157_reads.fastq.gz")
    lines = f"{smp}\n{reads}\n"
    got, _res = _two_process_cli(["profile", "--serve", db], tmp_path,
                                 stdin=lines.encode())
    a, b = _jax_host_tsv([db, smp]), _jax_host_tsv([db, reads])
    assert got == a + "".join(b.splitlines(True)[1:])
    assert len(got.splitlines()) >= 3
    assert got == _one_process_tsv(["profile", "--serve", db], monkeypatch,
                                   tmp_path, stdin=lines)


def test_dryrun_multichip_four_cpu_ranks():
    multichip.dryrun_multichip(4, "cpu", timeout_s=_TIMEOUT_S)


def test_unreachable_coordinator_fails_within_its_timeout(monkeypatch,
                                                          tmp_path):
    """Process 1 of 2 with no process 0 listening: the group is never
    formed, and the call fails within about twice the group's timeout
    instead of waiting for ever; no group is left behind."""
    import torch.distributed as dist
    monkeypatch.setattr(ud, "TIMEOUT_S", 2.0)
    t0 = time.monotonic()
    with pytest.raises(Exception) as err:
        cli.main(["profile", "db.syldb", "s.sylsp", "--device", "cpu",
                  "--coordinator", f"127.0.0.1:{multichip.free_port()}",
                  "--num-processes", "2", "--process-id", "1"])
    assert time.monotonic() - t0 < 30
    assert "timed out" in str(err.value).lower() or \
        "timeout" in type(err.value).__name__.lower()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="--num-processes"):
        ud.init_from_flags("127.0.0.1:1", None, None)


def test_dryrun_and_workers_default_to_the_card():
    """Like every entry point of the port, the dry run and its workers
    take the card unless the caller asks for the CPU: without enough GPUs
    the default raises before any rank starts."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this checks the refusal without two GPUs")
    with pytest.raises(RuntimeError, match="GPUs"):
        multichip.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="GPUs"):
        multichip.main(["dryrun", "2"])
    ap = multichip._parser()
    assert ap.parse_args(["dryrun", "2"]).device == "cuda"
    assert ap.parse_args(["worker", "step", "--address", "h:1", "--world",
                          "1", "--rank", "0"]).device == "cuda"
