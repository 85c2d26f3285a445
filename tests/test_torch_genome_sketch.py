"""The port's genome sketching against the JAX package on the CPU.

- ``parse_fastx`` (streamed blocks joined) against the JAX whole-file
  parser: codes, record bounds and names, over plain, gzip and many-block
  files.
- ``genome_survivor_positions(device=cpu)`` (the plain B7 at L = 4096)
  against the JAX package's and the native C seeder: contigs, end
  positions and hashes identical, over contigs shorter than k, exactly one
  row long, one base past it, and many rows long.
- Sketches: ``sketch_genome``/``sketch_genome_individual`` with seeding on
  the CPU and with the native seeder (``device=None``) against the JAX
  package's; ``sketch -g`` (plain and ``-i``, ``--gl``, ``-l``,
  ``--min-spacing``, ``--disable-profiling``) writes .syldb files byte
  for byte equal to the JAX package's, on ``test_files/`` E. coli genomes
  (c=100), the 80-genome world (c=25) and multi-contig genomes with N runs
  and repeated segments.
- Failures: an input that is not fasta is skipped as in the JAX package; a
  native library that fails to load raises.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from sylph_tpu.core.sketch_genomes import sketch_genome as j_sketch_genome
from sylph_tpu.core.sketch_genomes import \
    sketch_genome_individual as j_sketch_individual
from sylph_tpu.engine import device_sketch as jds
from sylph_tpu.engine.sketch_cmd import SketchOptions, sketch as j_sketch_cmd
from sylph_tpu.io.fastx import parse_fastx as j_parse
from sylph_tpu_torch import cli
from sylph_tpu_torch.core.native_core import seed_positions_native
from sylph_tpu_torch.core.sketch_genomes import (sketch_genome,
                                                 sketch_genome_individual)
from sylph_tpu_torch.engine import device_sketch as tds
from sylph_tpu_torch.io.fastx import parse_fastx
from sylph_tpu_torch.utils import cbuild
from tests.test_torch_cli import world  # noqa: F401

torch.set_num_threads(1)
TF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "test_files")
ECOLI = [os.path.join(TF, f"e.coli-{g}.fasta.gz")
         for g in ("EC590", "K12", "o157")]
CPU = torch.device("cpu")
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(scope="module")
def assemblies(tmp_path_factory):
    """Four multi-contig genomes: contig lengths from 10 to 30,000 bases
    (4,096 and 4,097 among them), a repeated 1.5 kb segment (the duplicate
    drop), N runs, lower-case runs, 60-column lines; two gzipped."""
    d = tmp_path_factory.mktemp("assemblies")
    rng = np.random.default_rng(17)
    paths = []
    for g in range(4):
        seg = _ACGT[rng.integers(0, 4, 1500)]
        recs = []
        lens = [int(x) for x in rng.integers(10, 30_000, size=2 + g)]
        lens += [4096, 4097] if g == 1 else []
        for ci, n in enumerate(lens):
            seq = _ACGT[rng.integers(0, 4, n)].copy()
            if n > 4000:
                at = int(rng.integers(0, n - 1500))
                seq[at:at + 1500] = seg
                nr = int(rng.integers(0, n - 200))
                seq[nr:nr + int(rng.integers(1, 200))] = ord("N")
                lc = int(rng.integers(0, n - 100))
                seq[lc:lc + 100] = np.char.lower(
                    seq[lc:lc + 100].view("S1")).view(np.uint8)
            lines = [seq[i:i + 60].tobytes() for i in range(0, n, 60)]
            recs.append(b">asm%d_contig%d len=%d\n" % (g, ci, n)
                        + b"\n".join(lines) + b"\n")
        text = b"".join(recs)
        p = d / (f"asm{g}.fa.gz" if g % 2 else f"asm{g}.fna")
        if g % 2:
            with gzip.open(p, "wb") as f:
                f.write(text)
        else:
            p.write_bytes(text)
        paths.append(str(p))
    (d / "junk.fa").write_bytes(b"this is not a fasta file\n")
    return d, paths


# ---- parsing and seeding ---------------------------------------------------

@pytest.mark.parametrize("target", [64 << 20, 4096])
def test_parse_fastx_matches_jax(assemblies, target):
    _, paths = assemblies
    for p in paths + ECOLI[:1]:
        got, want = parse_fastx(p, target_bytes=target), j_parse(p)
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.starts, want.starts)
        np.testing.assert_array_equal(got.ends, want.ends)
        assert got.names == want.names and len(got.names) >= 2 or \
            p in ECOLI


@pytest.mark.parametrize("c,k", [(25, 31), (200, 31), (5, 21), (3, 9)])
def test_genome_survivor_positions_matches_jax(assemblies, c, k):
    _, paths = assemblies
    px = parse_fastx(paths[1])
    jp = j_parse(paths[1])
    want = jds.genome_survivor_positions(jp, c, k)
    got = tds.genome_survivor_positions(px, c, k, CPU)
    native = seed_positions_native(px.codes, px.starts, px.ends, c, k)
    for g, w, n in zip(got, want, native):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, n)
    assert got[2].size > 100


def test_genome_rows_cover_every_window():
    """Rows overlap by k-1 bases: the windows of a contig are each in
    exactly one row, and no row holds more than _GBLOCK bases."""
    from sylph_tpu_torch.io.fastx import ParsedFastx
    lens = np.array([30, 31, 4096, 4097, 4127, 12_345, 0])
    ends = np.cumsum(lens)
    px = ParsedFastx(np.zeros(int(lens.sum()), np.uint8), ends - lens, ends)
    k = 31
    cid, off, rlen = tds._genome_rows(px, k)
    assert rlen.max() <= tds._GBLOCK and rlen.min() >= k
    for i, n in enumerate(lens):
        m = cid == i
        wins = np.concatenate([o + np.arange(r - k + 1)
                               for o, r in zip(off[m], rlen[m])] or
                              [np.empty(0, np.int64)])
        np.testing.assert_array_equal(wins, np.arange(max(n - k + 1, 0)))


# ---- sketches --------------------------------------------------------------

def _same(got, want):
    np.testing.assert_array_equal(got.genome_kmers, want.genome_kmers)
    if want.pseudotax_tracked_nonused_kmers is None:
        assert got.pseudotax_tracked_nonused_kmers is None
    else:
        np.testing.assert_array_equal(got.pseudotax_tracked_nonused_kmers,
                                      want.pseudotax_tracked_nonused_kmers)
    for f in ("file_name", "first_contig_name", "c", "k", "gn_size",
              "min_spacing"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("pseudotax", [True, False])
def test_sketch_genome_matches_jax(assemblies, device, pseudotax):
    _, paths = assemblies
    dev = None if device is None else torch.device(device)
    for p in paths:
        _same(sketch_genome(50, 31, p, 30, pseudotax, device=dev),
              j_sketch_genome(50, 31, p, 30, pseudotax))
        got = sketch_genome_individual(50, 31, p, 40, pseudotax, device=dev)
        want = j_sketch_individual(50, 31, p, 40, pseudotax)
        assert len(got) == len(want) >= 2
        for a, b in zip(got, want):
            _same(a, b)


def _syldb_pair(tmp_path, argv, **opts):
    """(port .syldb bytes, JAX .syldb bytes) of one sketch call."""
    j_sketch_cmd(SketchOptions(db_out_name=str(tmp_path / "j"), **opts))
    assert cli.main(["sketch", *argv, "-o", str(tmp_path / "p"),
                     "--device", "cpu"]) == 0
    return ((tmp_path / "p.syldb").read_bytes(),
            (tmp_path / "j.syldb").read_bytes())


@pytest.mark.parametrize("individual", [False, True])
def test_sketch_cli_ecoli_syldb_identical_to_jax(tmp_path, individual):
    flag = ["-i"] if individual else []
    got, want = _syldb_pair(tmp_path, ["-g", *ECOLI, "-c", "100", "-t", "3",
                                       *flag],
                            files=[], genomes=ECOLI, c=100, threads=3,
                            individual=individual)
    assert got == want and len(want) > 10_000


@pytest.mark.parametrize("individual", [False, True])
def test_sketch_cli_world_syldb_identical_to_jax(world, tmp_path,
                                                 individual):
    gs = sorted(str(p) for p in world.glob("g0*.fa.gz"))
    flag = ["-i"] if individual else []
    got, want = _syldb_pair(tmp_path, [*gs, "-c", "25", "-t", "4", *flag],
                            files=gs, c=25, threads=4,
                            individual=individual)
    assert got == want and len(gs) == 80


def test_sketch_cli_lists_and_options(assemblies, tmp_path):
    """--gl and -l list files (the -l list routes by extension and skips a
    file of neither kind), --min-spacing, --disable-profiling, -i, and an
    input that is not fasta (warned and skipped)."""
    d, paths = assemblies
    gl = tmp_path / "genomes.txt"
    gl.write_text("\n".join(paths[:2] + [str(d / "junk.fa")]) + "\n")
    ll = tmp_path / "seqs.txt"
    ll.write_text("\n".join(paths[2:] + [str(d / "notes.txt")]) + "\n")
    got, want = _syldb_pair(
        tmp_path, ["--gl", str(gl), "-l", str(ll), "--min-spacing", "45",
                   "--disable-profiling", "-i", "-c", "20", "-k", "21"],
        files=[], list_genomes=str(gl), list_sequence=str(ll),
        min_spacing_kmer=45, no_pseudotax=True, individual=True, c=20, k=21)
    assert got == want and len(want) > 1000


def test_invalid_genome_is_skipped(assemblies):
    d, _ = assemblies
    bad = str(d / "junk.fa")
    assert sketch_genome(50, 31, bad, 30, True, device=CPU) is None
    assert sketch_genome_individual(50, 31, str(d / "missing.fa"), 30, True,
                                    device=CPU) == []


@pytest.mark.parametrize("device", [None, "cpu"])
def test_genome_library_failure_raises(assemblies, device, monkeypatch):
    """A native library that will not load fails the sketch: the genome
    is not skipped as a bad input."""
    def broken_load(*args, **kwargs):
        raise OSError("libsketchcore.so: cannot open shared object file")

    monkeypatch.setattr(cbuild, "load", broken_load)
    _, paths = assemblies
    dev = None if device is None else torch.device(device)
    with pytest.raises(OSError, match="cannot open shared object"):
        sketch_genome(50, 31, paths[0], 30, True, device=dev)
