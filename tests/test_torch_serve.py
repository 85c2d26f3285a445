"""The port's resident-index surfaces on the CPU: ``--serve``,
``SYLPH_TPU_CACHE_INDEX`` and ``--profile-trace`` (the port of
tests/test_cli_integration.py:275-345).

- ``python -m sylph_tpu_torch profile --serve db.syldb --device cpu`` with
  requests on stdin: a sketch, the same reads raw, a missing path, a
  three-token line, a read pair and the sketch again. Rows equal the
  one-shot CLI's (and the JAX host engine's), the raw request's rows the
  sketch's, the warm repeat's the first's; the run goes on past the bad
  lines and EOF exits 0. No database exits 1; without a GPU and without
  ``--device cpu`` the run exits non-zero (the JAX serve falls back to the
  host, runner.py:716-725).
- In-process ``runner.serve`` in the grange regime (GRANGE_MIN = 0), a raw
  request streamed to the device view: rows equal the one-shot call's.
- ``SYLPH_TPU_CACHE_INDEX=1``: two ``contain`` calls build one engine and
  parse the database once; a rewritten ``.syldb`` (new mtime) builds a new
  one; a fasta input bypasses the caches.
- ``--profile-trace DIR`` writes a Chrome trace file of the sample loop,
  also under ``--serve``; a trace that cannot be written fails the run
  (the JAX trace warns and goes on, utils/timing.py:63-83).
"""

import io
import json
import os
import subprocess
import sys

import pytest
import torch

from sylph_tpu.engine.runner import ContainOptions as JOptions
from sylph_tpu.engine.runner import contain as jcontain
from sylph_tpu.engine.sketch_cmd import SketchOptions, sketch
from sylph_tpu_torch import cli
from sylph_tpu_torch.engine import runner
from sylph_tpu_torch.engine.device_exec import DeviceContainment
from tests.test_torch_api import _count_engines
from tests.test_torch_cli import world  # noqa: F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF = os.path.join(REPO, "test_files")


def tf(name):
    return os.path.join(TF, name)


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    """db.syldb of the three E. coli genomes and o157_reads.fastq.gz.sylsp,
    sketched by the JAX package."""
    d = tmp_path_factory.mktemp("torch_serve")
    sketch(SketchOptions(files=[], genomes=[
        tf(f"e.coli-{g}.fasta.gz") for g in ("EC590", "K12", "o157")],
        reads=[tf("o157_reads.fastq.gz")], db_out_name=str(d / "db"),
        sample_output_dir=str(d)))
    return d


def _serve_proc(args, req, env=None):
    return subprocess.run(
        [sys.executable, "-m", "sylph_tpu_torch", *args], input=req,
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, SYLPH_NO_MALLOC_TUNE="1", **(env or {})))


def _one_shot(mode, argv, tmp_path, tag):
    out = tmp_path / f"{tag}.tsv"
    assert cli.main([mode, *argv, "--device", "cpu", "-o", str(out)]) == 0
    return out.read_text().splitlines()


def test_serve_mode(d, tmp_path):
    db, sylsp = str(d / "db.syldb"), str(d / "o157_reads.fastq.gz.sylsp")
    r1, r2 = tf("k12_R1.fq"), tf("k12_R2.fq")
    req = "\n".join([sylsp, tf("o157_reads.fastq.gz"), f"{d}/nope.fq",
                     f"{d}/nope.sylsp", "a b c", f"{r1} {r2}", sylsp, ""])
    rs = _serve_proc(["profile", "--serve", db, "--device", "cpu"], req)
    assert rs.returncode == 0, rs.stderr
    assert "expected 1 or 2 paths per line, got 3" in rs.stderr
    assert "nope.sylsp failed (exit 1); continuing" in rs.stderr

    one = _one_shot("profile", [db, sylsp], tmp_path, "one")
    want = io.StringIO()
    jcontain(JOptions(files=[db, sylsp]), pseudotax=True, out=want)
    assert one == want.getvalue().splitlines()
    pair = _one_shot("profile", [db, "-1", r1, "-2", r2], tmp_path, "pair")
    lines = rs.stdout.splitlines()
    n, npair = len(one) - 1, len(pair) - 1
    assert n >= 1 and npair >= 1
    assert lines[0] == one[0]                           # header
    assert lines[1:1 + n] == one[1:]                    # the sketch
    raw = lines[1 + n:1 + 2 * n]                        # the same reads raw
    assert [r.split("\t")[1:] for r in raw] == \
        [r.split("\t")[1:] for r in one[1:]]
    assert lines[1 + 2 * n:1 + 2 * n + npair] == pair[1:]   # the pair
    assert lines[1 + 2 * n + npair:] == one[1:]         # the warm repeat


def test_serve_query_rows_equal_one_shot(d, tmp_path):
    db, sylsp = str(d / "db.syldb"), str(d / "o157_reads.fastq.gz.sylsp")
    rs = _serve_proc(["query", "--serve", db, "--device", "cpu"],
                     f"{sylsp}\n")
    assert rs.returncode == 0, rs.stderr
    assert rs.stdout.splitlines() == _one_shot("query", [db, sylsp],
                                               tmp_path, "q")


def test_serve_requires_database():
    rs = _serve_proc(["profile", "--serve", "--device", "cpu"], "")
    assert rs.returncode == 1


def test_serve_without_gpu_exits_nonzero(d):
    """No fall-back to the host: --serve on the default device (the GPU),
    with no GPU visible, fails before it reads a request."""
    rs = _serve_proc(["profile", "--serve", str(d / "db.syldb")],
                     str(d / "o157_reads.fastq.gz.sylsp") + "\n",
                     env=dict(CUDA_VISIBLE_DEVICES=""))
    assert rs.returncode != 0
    assert "no CUDA GPU is available" in rs.stderr
    assert rs.stdout == ""


def test_serve_in_process_grange(world, tmp_path, monkeypatch):  # noqa: F811
    """runner.serve on the grange engine: samples from argv first, then
    the stream; the raw request streams to the device view and takes the
    one-fetch mask sweep; each block of rows equals the one-shot call's."""
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    db, rf = str(world / "db.syldb"), str(world / "sample.fq")
    sylsp = str(world / "sample.fq.sylsp")
    one = _one_shot("profile", [db, sylsp, "-c", "25"], tmp_path, "one")
    raw = _one_shot("profile", [db, rf, "-c", "25"], tmp_path, "raw")
    engines = []
    make = runner._device_engine_for
    monkeypatch.setattr(runner, "_device_engine_for", lambda *a, **kw:
                        engines.append(make(*a, **kw)) or engines[-1])
    out = io.StringIO()
    runner.serve(runner.ContainOptions(files=[db, sylsp], c=25,
                                       device="cpu"),
                 pseudotax=True, out=out,
                 in_stream=io.StringIO(f"{rf}\n\n{sylsp}\n"))
    lines = out.getvalue().splitlines()
    n, m = len(one) - 1, len(raw) - 1
    assert lines == one + raw[1:] + one[1:]
    assert n >= 1 and m >= 1
    (eng,) = engines
    assert eng._grange is not None
    assert eng._grange.counters["mask_stream_masks"] == 1


def test_cache_index_one_engine_per_database(d, tmp_path, monkeypatch):
    monkeypatch.setattr(runner, "_ENGINE_CACHE", {})
    monkeypatch.setattr(runner, "_SKETCH_CACHE", {})
    monkeypatch.setenv("SYLPH_TPU_CACHE_INDEX", "1")
    built = _count_engines(monkeypatch)
    reads = []
    real_read = runner.sylformat.read_syldb
    monkeypatch.setattr(runner.sylformat, "read_syldb", lambda p: reads.append(
        p) or real_read(p))
    db = str(tmp_path / "db.syldb")
    with open(d / "db.syldb", "rb") as f, open(db, "wb") as g:
        g.write(f.read())
    sylsp = str(d / "o157_reads.fastq.gz.sylsp")

    def call(*files):
        out = io.StringIO()
        runner.contain(runner.ContainOptions(files=[*files, sylsp],
                                             device="cpu"),
                       pseudotax=True, out=out)
        return out.getvalue()

    first = call(db)
    assert call(db) == first
    assert built[0] == 1 and len(reads) == 1
    os.utime(db, (1, 1))                      # a rewritten database
    assert call(db) == first
    assert built[0] == 2 and len(reads) == 2
    call(db, tf("e.coli-o157.fasta.gz"))      # fasta: no cache
    call(db, tf("e.coli-o157.fasta.gz"))
    assert built[0] == 4
    monkeypatch.delenv("SYLPH_TPU_CACHE_INDEX")
    call(db)
    call(db)
    assert built[0] == 6


def _trace_files(trace_dir):
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    assert len(files) == 1 and files[0].endswith(".json")
    with open(files[0]) as f:
        return json.load(f)


@pytest.mark.parametrize("serve", [False, True])
def test_profile_trace_written(d, tmp_path, monkeypatch, serve):
    db, sylsp = str(d / "db.syldb"), str(d / "o157_reads.fastq.gz.sylsp")
    trace = tmp_path / "trace"
    argv = ["profile", db, "--device", "cpu", "--profile-trace", str(trace),
            "-o", str(tmp_path / "out.tsv")]
    if serve:
        monkeypatch.setattr(sys, "stdin", io.StringIO(sylsp + "\n"))
        argv.append("--serve")
    else:
        argv.append(sylsp)
    assert cli.main(argv) == 0
    events = _trace_files(trace)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert (tmp_path / "out.tsv").read_text().count("\n") >= 2


def test_profile_trace_failure_raises(d, tmp_path, monkeypatch):
    """A trace that cannot be written fails the run: no exit 0 without
    the trace that was asked for."""
    def broken(self, path):
        raise OSError("disk full")
    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace",
                        broken)
    with pytest.raises(OSError, match="disk full"):
        cli.main(["profile", str(d / "db.syldb"),
                  str(d / "o157_reads.fastq.gz.sylsp"), "--device", "cpu",
                  "--profile-trace", str(tmp_path / "t")])
