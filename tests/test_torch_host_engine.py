"""The port's host engine (``--device host``, ``api`` ``device="host"``)
against the JAX package's host engine (its CLI and API without ``--tpu``):
the native C seeder, host searchsorted probes and host statistics, no
device engine and no kernel.

The database is tests/test_torch_multidevice.py's o157 world: the three
E. coli genomes and 64 random decoys (G = 67 >= 64, so the prefilter runs
its host histograms, ``host_counts_chunks``). Cases: a ``.sylsp``, raw
reads, ``-1/-2`` and two samples at ``-t 4`` (``sample_parallelism_step``
workers), through ``profile`` and ``query``, ``--serve`` and ``sketch``.
``process_sample(device_engine=None)`` at G >= 64 raised AttributeError
before the host branch of ``prefilter_candidates`` existed.
"""

import io
import os

import numpy as np
import pytest
import torch

import sylph_tpu.api as jsylph
import sylph_tpu.engine.prefilter as jpf
import sylph_tpu.engine.runner as jrunner
from sylph_tpu import cli as jcli
from sylph_tpu.engine.runner import ContainOptions as JOptions
from sylph_tpu_torch import api, cli
from sylph_tpu_torch.engine import device_exec, prefilter, runner
from sylph_tpu_torch.engine.runner import ContainOptions
from sylph_tpu_torch.gpu import _cuda
from sylph_tpu_torch.io import sylformat
from tests.test_torch_multidevice import make_o157_world

torch.set_num_threads(1)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TF = os.path.join(_REPO, "test_files")
_READS = os.path.join(_TF, "o157_reads.fastq.gz")
_R1, _R2 = os.path.join(_TF, "k12_R1.fq"), os.path.join(_TF, "k12_R2.fq")


@pytest.fixture(scope="module")
def o157(tmp_path_factory):
    d = tmp_path_factory.mktemp("o157_host")
    make_o157_world(d)
    return d


@pytest.fixture
def no_device(monkeypatch):
    """The host engine builds no device engine and launches no kernel."""
    def refuse(*a, **kw):
        raise AssertionError("the host engine built a device engine")
    monkeypatch.setattr(device_exec.DeviceContainment, "__init__", refuse)
    _cuda.reset_launches()
    yield
    assert not any(_cuda.LAUNCHES.values()), _cuda.LAUNCHES


def _run(main, argv, path):
    assert main([*argv, "-o", str(path)]) == 0
    return path.read_text()


def _cases(d):
    db, smp = str(d / "db.syldb"), str(d / "sample.sylsp")
    return {
        "sylsp": [db, smp],
        "raw": [db, _READS],
        "pair": [db, "-1", _R1, "-2", _R2],
        "two_t4": [db, _READS, smp, "-t", "4"],
    }


@pytest.mark.parametrize("mode", ["profile", "query"])
@pytest.mark.parametrize("case", ["sylsp", "raw", "pair", "two_t4"])
def test_host_cli_matches_jax_host_engine(o157, tmp_path, no_device, mode,
                                          case):
    argv = [mode, *_cases(o157)[case]]
    want = _run(jcli.main, argv, tmp_path / "jax.tsv")
    got = _run(cli.main, [*argv, "--device", "host"], tmp_path / "port.tsv")
    assert got == want
    assert len(want.splitlines()) >= 2          # a header and hits


def test_serve_host_matches_jax_host_engine(o157, tmp_path, no_device):
    db, smp = str(o157 / "db.syldb"), str(o157 / "sample.sylsp")
    want = io.StringIO()
    jrunner.serve(JOptions(files=[db], threads=2), pseudotax=True, out=want,
                  in_stream=io.StringIO(f"{smp}\n{_R1} {_R2}\n"))
    got = io.StringIO()
    runner.serve(ContainOptions(files=[db], threads=2, device="host"),
                 pseudotax=True, out=got,
                 in_stream=io.StringIO(f"{smp}\n{_R1} {_R2}\n"))
    assert got.getvalue() == want.getvalue()
    assert len(want.getvalue().splitlines()) >= 3


def test_process_sample_without_device_engine_at_64_genomes(o157):
    """The library call with device_engine=None against G >= 64 genomes:
    the prefilter probes on the host (it called None.candidates_mask
    before), rows equal the JAX host engine's."""
    db = sylformat.read_syldb(str(o157 / "db.syldb"))
    smp = sylformat.read_sylsp(str(o157 / "sample.sylsp"))
    assert len(db) >= 64
    got = runner.process_sample(ContainOptions(pseudotax=True), smp, db,
                                None)
    jdb = jsylph.load_db(str(o157 / "db.syldb"))
    jsmp = jsylph.load_sample(str(o157 / "sample.sylsp"))
    want = jrunner.process_sample(JOptions(pseudotax=True), jsmp, jdb, None)
    assert got
    assert [(r.gn_name, r.final_est_ani, r.final_est_cov, r.rel_abund,
             r.containment_index) for r in got] == \
        [(r.gn_name, r.final_est_ani, r.final_est_cov, r.rel_abund,
          r.containment_index) for r in want]


def test_api_host_matches_jax_host_engine(o157, no_device):
    db = api.load_db(str(o157 / "db.syldb"))
    smp = api.load_sample(str(o157 / "sample.sylsp"))
    jdb = jsylph.load_db(str(o157 / "db.syldb"))
    jsmp = jsylph.load_sample(str(o157 / "sample.sylsp"))
    prof = api.Profiler(db, device="host")
    jprof = jsylph.Profiler(jdb, tpu=False)
    for got, want in ((prof.profile(smp), jprof.profile(jsmp)),
                      (prof.query(_READS), jprof.query(_READS)),
                      (api.profile(db, smp, device="host"),
                       jsylph.profile(jdb, jsmp)),
                      (api.query(db, smp, device="host"),
                       jsylph.query(jdb, jsmp))):
        assert got and [r.__dict__ for r in got] == \
            [r.__dict__ for r in want]


def test_sketch_host_matches_jax(tmp_path, no_device):
    """``sketch --device host -t 4``: read files on the pool, pairs and
    genomes; every output byte for byte the JAX CLI's without --tpu."""
    gen = [os.path.join(_TF, f"e.coli-{n}.fasta.gz") for n in ("K12", "o157")]
    for side, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "host"])):
        d = tmp_path / side
        assert main(["sketch", "-r", _READS, _R1, "-1", _R1, "-2", _R2,
                     "-g", *gen, "-o", str(d / "db"), "-d", str(d),
                     "-t", "4", *extra]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


@pytest.mark.parametrize("chunk", [1 << 25, 30_000])
def test_host_counts_and_hists_match_jax(o157, monkeypatch, chunk):
    monkeypatch.setattr(prefilter, "_HOST_CHUNK", chunk)
    monkeypatch.setattr(jpf, "_HOST_CHUNK", chunk)
    db = sylformat.read_syldb(str(o157 / "db.syldb"))
    smp = sylformat.read_sylsp(str(o157 / "sample.sylsp"))
    jdb = jsylph.load_db(str(o157 / "db.syldb"))
    jsmp = jsylph.load_sample(str(o157 / "sample.sylsp"))
    got = list(prefilter.host_counts_chunks(db, smp))
    want = list(jpf.host_counts_chunks(jdb, jsmp))
    assert len(got) == len(want) and len(got) >= (2 if chunk < 1e6 else 1)
    for (c, g), (jc, jg) in zip(got, want):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(g, jg)
    h = prefilter.genome_hists(iter(got), len(db))
    np.testing.assert_array_equal(h, jpf.genome_hists(iter(want), len(db)))
    assert h[:, 1:].sum() > 0


def test_sample_parallelism_step_matches_jax():
    for pseudotax in (False, True):
        for threads in (1, 2, 3, 4, 8, 17):
            for sample_threads in (None, -1, 0, 1, 5):
                for n_raw in (0, 1, 2, 7, 40):
                    args = (pseudotax, threads, sample_threads, n_raw)
                    assert runner.sample_parallelism_step(*args) == \
                        jrunner.sample_parallelism_step(*args), args


def test_host_is_asked_for_by_name_only(o157, tmp_path):
    """``cuda`` stays the default and raises without a GPU: the host engine
    is no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    db, smp = str(o157 / "db.syldb"), str(o157 / "sample.sylsp")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["query", db, smp, "-o", str(tmp_path / "x.tsv")])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        api.Profiler(api.load_db(db))
    assert runner.engine_device("host") is None
