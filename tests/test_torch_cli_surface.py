"""The port's one-card CLI surface against the JAX CLI, on the CPU:
``inspect``, the sketch list files ``--rl``, ``--l1`` and ``--l2``, and
the allocator re-exec.

- ``inspect`` on the cases of tests/test_cli_integration.py::test_inspect
  (a ``.syldb`` of two genomes and a read set, a paired ``.sylsp``): stdout
  and the ``-o`` file byte-identical to ``sylph_tpu.cli.main``'s. With no
  files the port exits 2; the JAX CLI exits 0 (ROADMAP C).
- ``sketch --l1/--l2`` and ``--gl``/``--rl`` on the cases of
  test_cli_integration.py's test_sketch_pair_lists and
  test_sketch_gl_rl_lists: the same files, byte for byte, as the JAX CLI;
  unequal pair lists exit 1 in both.
- ``_tune_allocator`` with ``os.execve`` patched: the argv and environment
  it would exec with (the JAX CLI's, with ``-m sylph_tpu_torch``), no exec
  under ``MALLOC_MMAP_THRESHOLD_`` or ``SYLPH_NO_MALLOC_TUNE``, and
  ``main([...])`` never execs.
"""

import os
import sys

import pytest
import torch

from sylph_tpu import cli as jcli
from sylph_tpu.engine.sketch_cmd import SketchOptions, sketch as j_sketch
from sylph_tpu_torch import cli

torch.set_num_threads(1)
TF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "test_files")


def tf(name):
    return os.path.join(TF, name)


@pytest.fixture(scope="module")
def sketched(tmp_path_factory):
    """test_inspect's inputs, sketched by the JAX package."""
    d = tmp_path_factory.mktemp("inspect")
    j_sketch(SketchOptions(files=[tf("e.coli-EC590.fasta.gz"),
                                  tf("e.coli-K12.fasta.gz"),
                                  tf("o157_reads.fastq.gz")],
                           db_out_name=str(d / "db"),
                           sample_output_dir=str(d), threads=3))
    j_sketch(SketchOptions(first_pair=[tf("k12_R1.fq")],
                           second_pair=[tf("k12_R2.fq")],
                           sample_output_dir=str(d)))
    return d


@pytest.mark.parametrize("names", [
    ["k12_R1.fq.paired.sylsp"], ["db.syldb"],
    ["db.syldb", "k12_R1.fq.paired.sylsp", "o157_reads.fastq.gz.sylsp",
     "not_a_sketch.txt"]])
def test_inspect_matches_jax(sketched, names, tmp_path, capsys):
    paths = [str(sketched / n) for n in names]
    assert jcli.main(["inspect", *paths]) == 0
    want = capsys.readouterr().out
    assert cli.main(["inspect", *paths]) == 0
    assert capsys.readouterr().out == want
    assert "k12_R1.fq" in want or "e.coli-EC590.fasta.gz" in want
    jo, po = tmp_path / "jax.yaml", tmp_path / "port.yaml"
    assert jcli.main(["inspect", *paths, "-o", str(jo)]) == 0
    assert cli.main(["inspect", "-o", str(po), *paths]) == 0
    assert po.read_bytes() == jo.read_bytes()
    assert capsys.readouterr().out == ""


def test_inspect_without_files_exits_2(capsys):
    assert cli.main(["inspect"]) == 2
    assert "inspect" in capsys.readouterr().err
    assert jcli.main(["inspect"]) == 0       # the JAX CLI's help exit


def _write(path, lines):
    path.write_text("".join(x + "\n" for x in lines))
    return str(path)


def _same_tree(a, b):
    fa = sorted(os.listdir(a))
    assert fa == sorted(os.listdir(b)) and fa
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def test_sketch_pair_lists_match_jax(tmp_path):
    p1 = _write(tmp_path / "p1.txt", [tf("t1.fq")])
    p2 = _write(tmp_path / "p2.txt", [tf("t2.fq")])
    jd, pd = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["sketch", "--l1", p1, "--l2", p2, "-d", str(jd)]) == 0
    assert cli.main(["sketch", "--l1", p1, "--l2", p2, "-d", str(pd),
                     "--device", "cpu"]) == 0
    assert os.listdir(pd) == ["t1.fq.paired.sylsp"]
    _same_tree(jd, pd)


def test_unequal_pair_lists_exit_1(tmp_path):
    p1 = _write(tmp_path / "p1.txt", [tf("t1.fq"), tf("k12_R1.fq")])
    p2 = _write(tmp_path / "p2.txt", [tf("t2.fq")])
    for main, extra in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
        assert main(["sketch", "--l1", p1, "--l2", p2, "-d",
                     str(tmp_path / "out"), *extra]) == 1
    assert not os.path.exists(tmp_path / "out")


def test_sketch_gl_rl_lists_match_jax(tmp_path):
    lst = _write(tmp_path / "list.txt", [tf("e.coli-EC590.fasta.gz"),
                                        tf("o157_reads.fastq.gz")])
    for tag, main, extra in (("jax", jcli.main, []),
                             ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / tag
        assert main(["sketch", "--gl", lst, "-o", str(d / "g" / "db"),
                     *extra]) == 0
        assert main(["sketch", "--rl", lst, "-o", str(d / "db3"), "-d",
                     str(d / "r"), *extra]) == 0
        assert not os.path.exists(d / "db3.syldb")
    assert sorted(os.listdir(tmp_path / "port" / "r")) == [
        "e.coli-EC590.fasta.gz.sylsp", "o157_reads.fastq.gz.sylsp"]
    for sub in ("g", "r"):
        _same_tree(tmp_path / "jax" / sub, tmp_path / "port" / sub)


_MALLOC = ("MALLOC_MMAP_THRESHOLD_", "MALLOC_TRIM_THRESHOLD_",
           "MALLOC_ARENA_MAX", "SYLPH_NO_MALLOC_TUNE")


@pytest.fixture
def execs(monkeypatch):
    """os.execve recorded instead of run, argv set, malloc variables
    cleared."""
    calls = []
    monkeypatch.setattr(os, "execve",
                        lambda exe, argv, env: calls.append((exe, argv, env)))
    for v in _MALLOC:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(sys, "argv", ["sylph", "inspect", "a.sylsp"])
    return calls


def test_tune_allocator_reexecs_as_the_jax_cli(execs):
    cli._tune_allocator()
    jcli._tune_allocator()
    (exe, argv, env), (jexe, jargv, jenv) = execs
    assert exe == jexe == sys.executable
    assert argv == [sys.executable, "-m", "sylph_tpu_torch", "inspect",
                    "a.sylsp"]
    assert jargv == [sys.executable, "-m", "sylph_tpu", "inspect",
                     "a.sylsp"]
    assert env == jenv == dict(os.environ,
                               MALLOC_MMAP_THRESHOLD_="17179869184",
                               MALLOC_TRIM_THRESHOLD_="-1",
                               MALLOC_ARENA_MAX="1")


@pytest.mark.parametrize("var,val", [("MALLOC_MMAP_THRESHOLD_", "1024"),
                                     ("SYLPH_NO_MALLOC_TUNE", "1")])
def test_tune_allocator_respects_opt_outs(execs, monkeypatch, var, val):
    monkeypatch.setenv(var, val)
    cli._tune_allocator()
    assert execs == []


def test_exec_refused_runs_untuned(execs, monkeypatch):
    def refuse(*a):
        raise OSError("exec denied")
    monkeypatch.setattr(os, "execve", refuse)
    cli._tune_allocator()
    assert os.environ.get("SYLPH_NO_MALLOC_TUNE") == "1"


def test_only_main_without_argv_execs(execs, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["sylph", "inspect"])
    assert cli.main(["inspect"]) == 2
    assert execs == []
    assert cli.main() == 2          # the recorded exec returned: runs on
    assert len(execs) == 1 and execs[0][1][1:3] == ["-m", "sylph_tpu_torch"]
