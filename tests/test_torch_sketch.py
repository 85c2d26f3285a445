"""The port's read seeding and sketching against the JAX package on the CPU.

- B7's plain version (gpu/seeding.py) against the Pallas seed kernel in
  interpret mode and the XLA seeding: keep identical, hashes identical
  where kept (the Pallas columns past L-k are garbage).
- B8's plain version (gpu/bucket_fill.py) against the Pallas pair repack in
  interpret mode: the int64 view of (hi, lo) bit for bit, overflow too.
- ``read_survivor_arrays(device=cpu)`` against the JAX package's on the CPU:
  read ids and hashes identical, over every bucket, long and short reads,
  and a forced condensation overflow (the lossless redo).
- Sketches and the ``sketch`` CLI on ``test_files/``: k-mers in insertion
  order, counts, mean read length and ``paired``; ``.sylsp`` files byte
  for byte.
- Failures: an input that cannot be opened is skipped (single-end) or
  ends the run (paired), as in the JAX package; a native library that
  fails to build or load raises instead of passing for a bad input.

Inputs are made by numpy from a seed; the port seeds on the CPU (its plain
kernel versions).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.core.sketch_reads import \
    sketch_pair_sequences as j_sketch_pair
from sylph_tpu.core.sketch_reads import sketch_sequences as j_sketch
from sylph_tpu.engine import device_sketch as jds
from sylph_tpu.engine.sketch_cmd import SketchOptions, sketch as j_sketch_cmd
from sylph_tpu.io.fastx import ParsedFastx as JParsed
from sylph_tpu.tpu.bucket_fill import repack2_flat as j_repack2
from sylph_tpu.tpu.pallas_seeding import seed_hashes_pallas
from sylph_tpu.tpu.seeding import seed_hashes as j_seed_hashes
from sylph_tpu_torch import cli
from sylph_tpu_torch.core.sketch_reads import (sketch_pair_sequences,
                                               sketch_sequences)
from sylph_tpu_torch.engine import device_sketch as tds
from sylph_tpu_torch.gpu import bucket_fill as tbf
from sylph_tpu_torch.gpu import seeding as tsd
from sylph_tpu_torch.gpu.keys import from_pair_np
from sylph_tpu_torch.io.fastx import ParsedFastx
from sylph_tpu_torch.utils import cbuild

torch.set_num_threads(1)
TF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "test_files")
CPU = torch.device("cpu")
SENT = np.uint32(0xFFFFFFFF)


# ---- B7: seeding -----------------------------------------------------------

@pytest.mark.parametrize("c,k", [(200, 31), (20, 31), (5, 21), (7, 16),
                                 (3, 9)])
def test_seed_plain_matches_pallas_and_xla(c, k):
    rng = np.random.default_rng(c * 100 + k)
    N, L = 128, 256
    bases = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, size=N).astype(np.int32)
    lens[:4] = (L, 0, k - 1, k)
    packed = torch.from_numpy(jds._pack16_rows(bases).view(np.int32))
    h, keep = tsd.seed_packed(packed, torch.from_numpy(lens), c=c, k=k)
    h, keep = h.numpy(), keep.numpy()
    assert h.shape == keep.shape == (N, L)
    ph, pl, pk = seed_hashes_pallas(jnp.asarray(bases.astype(np.uint32)),
                                    jnp.asarray(lens), c=c, k=k,
                                    interpret=True)
    pk = np.asarray(pk)
    np.testing.assert_array_equal(keep, pk)
    np.testing.assert_array_equal(h[pk], from_pair_np(ph, pl)[pk])
    W = L - k + 1
    xh, xl, xk = j_seed_hashes(jnp.asarray(bases.astype(np.uint32)),
                               jnp.asarray(lens), c=c, k=k)
    np.testing.assert_array_equal(keep[:, :W], np.asarray(xk))
    assert not keep[:, W:].any()
    xk = np.asarray(xk)
    np.testing.assert_array_equal(h[:, :W][xk], from_pair_np(xh, xl)[xk])
    assert keep.sum() > 0


def test_pack16_rows_matches_jax():
    """The wire format: the port's byte-wise packing gives the JAX
    package's words."""
    b = np.random.default_rng(1).integers(0, 4, (40, 512)).astype(np.uint8)
    got = tds._pack16_rows(b)
    assert got.dtype == np.uint32 and got.shape == (40, 32)
    np.testing.assert_array_equal(got, jds._pack16_rows(b))


def test_seed_rejects_bad_k():
    packed = torch.zeros((8, 16), dtype=torch.int32)
    lens = torch.zeros(8, dtype=torch.int32)
    for k in (0, 32):
        with pytest.raises(ValueError):
            tsd.seed_packed(packed, lens, c=200, k=k)


# ---- B8: pair-stream repack ------------------------------------------------

@pytest.mark.parametrize("seed,n,row,cap,dens", [
    (0, 30_000, 2048, 512, 0.15), (1, 40_000, 8192, 1792, 0.16),
    (2, 30_000, 2048, 512, 0.35)])        # the last overflows its windows
def test_repack2_plain_matches_pallas(seed, n, row, cap, dens):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**31, size=n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    dead = rng.random(n) > dens
    hi[dead] = SENT
    lo[dead] = SENT
    gh, gl = j_repack2(jnp.asarray(hi), jnp.asarray(lo), row=row, cap=cap,
                       interpret=True)
    want = from_pair_np(np.asarray(gh), np.asarray(gl))
    keys = torch.from_numpy(from_pair_np(hi, lo))
    got = tbf.repack2_flat(keys, row=row, cap=cap).numpy()
    np.testing.assert_array_equal(got, want)
    lost = int((~dead).sum()) - int((got != -1).sum())
    assert (lost > 0) == (seed == 2)


def test_condense_plan_matches_jax_chain(monkeypatch):
    """The port's condense_stream runs the JAX chain's passes: (row, cap)
    per pass from the same arithmetic, for the read batch shapes."""
    from sylph_tpu.tpu import bucket_fill as jbf
    from sylph_tpu.tpu import pipeline as jpl
    seen = []

    def spy(hi, lo, *, row, cap, interpret=False):
        seen.append((row, cap))
        z = jnp.full(8 * (-(-hi.size // (8 * row))) * cap, SENT, jnp.uint32)
        return z, z

    monkeypatch.setattr(jbf, "repack2_flat", spy)
    for L, c, k in [(256, 200, 31), (128, 20, 21), (512, 5, 31)]:
        W = L - k + 1
        cap = tds._row_cap(W, c)
        n = 4096 * cap
        exp = (W / c) / cap
        seen.clear()
        z = jnp.full(n, SENT, jnp.uint32)
        jpl.condense_stream(z, z, exp, interpret=True)
        assert tbf.condense_plan(n, exp) == seen
        assert seen


# ---- read_survivor_arrays --------------------------------------------------

def _reads(seed, lengths):
    rng = np.random.default_rng(seed)
    lens = np.asarray(lengths, np.int64)
    codes = rng.integers(0, 4, size=int(lens.sum())).astype(np.uint8)
    ends = np.cumsum(lens)
    return codes, ends - lens, ends


def _read_lengths(seed, n):
    """Every bucket (<=128, <=256, <=512), reads over 512 bases (host
    seeding) and reads shorter than k, shuffled."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([
        rng.integers(31, 129, n), rng.integers(129, 257, n),
        rng.integers(257, 513, n // 2), rng.integers(513, 900, 6),
        rng.integers(1, 31, 10), [31, 128, 256, 512, 513]])
    return rng.permutation(lens)


@pytest.mark.parametrize("c,k", [(20, 31), (5, 21)])
def test_read_survivor_arrays_matches_jax(c, k):
    codes, starts, ends = _reads(c + k, _read_lengths(c, 300))
    want = jds.read_survivor_arrays(JParsed(codes, starts, ends), c, k)
    got = tds.read_survivor_arrays(ParsedFastx(codes, starts, ends), c, k,
                                   CPU)
    assert got[0].dtype == np.int64 and got[1].dtype == np.uint64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].size > 1000


def test_host_and_device_seeding_match_numpy_reference():
    """The port's host C seeder (device None's) and its device seeding (on
    the CPU, the plain kernels) both give the numpy reference
    (kmer/seeding.py::fmh_seeds_concat_np) over reads of every length."""
    from sylph_tpu_torch.core.native_core import seed_concat_native
    from sylph_tpu_torch.kmer.seeding import fmh_seeds_concat_np
    codes, starts, ends = _reads(9, _read_lengths(9, 200))
    want = fmh_seeds_concat_np(codes, starts, ends, 10, 31)
    assert want[1].size > 1000
    for got in (seed_concat_native(codes, starts, ends, 10, 31),
                tds.read_survivor_arrays(ParsedFastx(codes, starts, ends),
                                         10, 31, CPU)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_read_survivor_arrays_overflow_redo(monkeypatch):
    """A condensation pass far below the survivors' density drops some;
    the count check sees it and the batch is redone without condensing,
    so the output is still identical."""
    codes, starts, ends = _reads(5, _read_lengths(5, 400))
    want = jds.read_survivor_arrays(JParsed(codes, starts, ends), 5, 21)
    monkeypatch.setattr(tbf, "condense_plan", lambda n, d: [(4096, 256)])
    redo = []
    seed_rows = tds._seed_rows
    monkeypatch.setattr(tds, "_seed_rows", lambda *a: redo.append(1)
                        or seed_rows(*a))
    got = tds.read_survivor_arrays(ParsedFastx(codes, starts, ends), 5, 21,
                                   CPU)
    n_batches = 3
    assert len(redo) > n_batches        # one per batch + the redone ones
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---- sketches --------------------------------------------------------------

def _same_sketch(got, want):
    np.testing.assert_array_equal(got.kmers, want.kmers)   # insertion order
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.mean_read_length == want.mean_read_length
    assert got.paired == want.paired
    assert got.kmers.size > 0


def test_sketch_single_matches_jax():
    f = os.path.join(TF, "o157_reads.fastq.gz")
    _same_sketch(sketch_sequences(f, 100, 31, device=CPU),
                 j_sketch(f, 100, 31, device=False))


@pytest.mark.parametrize("r1,r2,c,k,fpr", [
    ("k12_R1.fq", "k12_R2.fq", 50, 31, 0.0),
    ("k12_R1.fq", "k12_R2.fq", 50, 31, 1e-4),
    ("t1.fq", "t2.fq", 5, 21, 0.0)])
def test_sketch_pair_matches_jax(r1, r2, c, k, fpr):
    f1, f2 = os.path.join(TF, r1), os.path.join(TF, r2)
    _same_sketch(sketch_pair_sequences(f1, f2, c, k, fpr=fpr, device=CPU),
                 j_sketch_pair(f1, f2, c, k, fpr=fpr, device=False))


def test_sketch_native_seeder_matches_device_seeding():
    """device=None (the native C seeder on the host, the oracle the card
    is held to) and seeding through the plain kernels agree."""
    f1, f2 = os.path.join(TF, "k12_R1.fq"), os.path.join(TF, "k12_R2.fq")
    _same_sketch(sketch_pair_sequences(f1, f2, 50, 31, device=None),
                 sketch_pair_sequences(f1, f2, 50, 31, device=CPU))


def test_sketch_cli_writes_sylsp_identical_to_jax(tmp_path):
    o157 = os.path.join(TF, "o157_reads.fastq.gz")
    r1, r2 = os.path.join(TF, "k12_R1.fq"), os.path.join(TF, "k12_R2.fq")
    j_sketch_cmd(SketchOptions(files=[], reads=[o157], first_pair=[r1],
                               second_pair=[r2], sample_names=["pairs",
                                                               "single"],
                               sample_output_dir=str(tmp_path / "j"),
                               c=100, threads=2))
    assert cli.main(["sketch", "-r", o157, "-1", r1, "-2", r2, "-S",
                     "pairs", "single", "-d", str(tmp_path / "p"), "-c",
                     "100", "-t", "2", "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == ["pairs.paired.sylsp", "single.sylsp"]
    assert sorted(os.listdir(tmp_path / "p")) == names
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()


def test_sketch_cli_genomes_not_ported(tmp_path):
    """Genome sketching is ported: ``sketch -g e.coli-K12.fasta.gz`` (the
    genome seeded through the plain kernels) writes the JAX package's
    .syldb byte for byte (tests/test_torch_genome_sketch.py has the
    rest)."""
    g = os.path.join(TF, "e.coli-K12.fasta.gz")
    j_sketch_cmd(SketchOptions(files=[], genomes=[g],
                               db_out_name=str(tmp_path / "j"), c=100))
    assert cli.main(["sketch", "-g", g, "-o", str(tmp_path / "p"), "-c",
                     "100", "--device", "cpu"]) == 0
    want = (tmp_path / "j.syldb").read_bytes()
    assert (tmp_path / "p.syldb").read_bytes() == want and len(want) > 1000


# ---- failures --------------------------------------------------------------

def test_unreadable_input_is_skipped(tmp_path):
    missing = str(tmp_path / "missing.fq")
    assert sketch_sequences(missing, 100, 31, device=CPU) is None
    with pytest.raises(SystemExit):
        sketch_pair_sequences(missing, os.path.join(TF, "k12_R2.fq"), 50,
                              31, device=CPU)


def _broken_load(*args, **kwargs):
    raise OSError("libsketchcore.so: cannot open shared object file")


@pytest.mark.parametrize("device", ["cpu", None])
@pytest.mark.parametrize("reads", ["single", "paired"])
def test_library_failure_is_not_a_bad_input(reads, device, monkeypatch):
    """An OSError from building or loading a native library is a fault of
    the program: it reaches the caller, never a skipped sample."""
    monkeypatch.setattr(cbuild, "load", _broken_load)
    dev = None if device is None else torch.device(device)
    with pytest.raises(OSError, match="cannot open shared object"):
        if reads == "single":
            sketch_sequences(os.path.join(TF, "o157_reads.fastq.gz"), 100,
                             31, device=dev)
        else:
            sketch_pair_sequences(os.path.join(TF, "k12_R1.fq"),
                                  os.path.join(TF, "k12_R2.fq"), 50, 31,
                                  device=dev)


def test_sketch_cli_library_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cbuild, "load", _broken_load)
    with pytest.raises(OSError, match="cannot open shared object"):
        cli.main(["sketch", "-r", os.path.join(TF, "o157_reads.fastq.gz"),
                  "-d", str(tmp_path), "-c", "100", "--device", "cpu"])
    assert os.listdir(tmp_path) == []
