"""The reference's golden TSVs (tests/golden/) through the port, on the CPU.

The port sketches the three test_files/ E. coli genomes and the o157 reads
(``sketch -g ... -r ... --device cpu``), then ``profile`` and ``query``
(``--device cpu``) must reproduce ``profile_o157.tsv``, ``query_o157.tsv``
and ``query_k12_u.tsv`` byte for byte (after the path normalisation of
tests/test_golden.py), through ``cli.main`` and through ``--serve`` with
the request on stdin.
"""

import io
import os
import sys

import pytest
import torch

from sylph_tpu_torch import cli

torch.set_num_threads(1)
TF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "test_files")
GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

# golden file -> (mode, extra flags, sample inputs: argv of the one-shot
# call, one request line of --serve)
_CASES = {
    "profile_o157.tsv": ("profile", [], "sylsp"),
    "query_o157.tsv": ("query", [], "sylsp"),
    "query_k12_u.tsv": ("query", ["-u"], "pair"),
}


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_golden")
    assert cli.main([
        "sketch", "-g", *[f"{TF}/e.coli-{g}.fasta.gz"
                          for g in ("EC590", "K12", "o157")],
        "-r", f"{TF}/o157_reads.fastq.gz", "-o", str(d / "db"), "-d",
        str(d), "--device", "cpu"]) == 0
    return d


def _normalize(text, d):
    return text.replace(str(d) + "/", "").replace(TF, "TESTFILES")


def _samples(kind, d):
    if kind == "sylsp":
        p = str(d / "o157_reads.fastq.gz.sylsp")
        return [p], p
    r1, r2 = f"{TF}/k12_R1.fq", f"{TF}/k12_R2.fq"
    return ["-1", r1, "-2", r2], f"{r1} {r2}"


@pytest.mark.parametrize("via", ["main", "serve"])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_golden_tsv(db, name, via, tmp_path, monkeypatch):
    mode, flags, kind = _CASES[name]
    argv, request = _samples(kind, db)
    out = tmp_path / "out.tsv"
    common = [mode, str(db / "db.syldb"), *flags, "--device", "cpu", "-o",
              str(out)]
    if via == "main":
        assert cli.main(common + argv) == 0
    else:
        monkeypatch.setattr(sys, "stdin", io.StringIO(request + "\n"))
        assert cli.main(common + ["--serve"]) == 0
    with open(os.path.join(GOLD, name)) as f:
        want = f.read()
    assert _normalize(out.read_text(), db) == want
