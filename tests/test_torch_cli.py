"""The port's entry points against the JAX package on the CPU.

- ``python -m sylph_tpu_torch profile/query --device cpu`` (in-process,
  through cli.main) with the grange engine forced (GRANGE_MIN = 0) on the
  80-genome world of tests/test_grange.py::test_grange_cli_parity, sketched
  by the JAX package's ``sketch``: TSVs byte-identical to the JAX host
  engine, ``contain(tpu=False)``.
- The same on raw reads (``o157_reads.fastq.gz``; ``-1 k12_R1.fq -2
  k12_R2.fq``) against a ``.syldb`` of ``test_files/`` genomes sketched by
  the JAX package: the reads are seeded through the port's plain kernels
  and streamed into the device view.
- Genome fasta inputs beside the database, and the merge regime with no
  patch (tests/test_torch_small_db.py covers the small-database regimes).
- Multi-sample cohorts: merge at its default depth, grange at depth 3 (one
  batched sweep) and at depth 1 with raw reads, a bad sketch mid-cohort,
  a sample skipped in place; TSVs byte-identical to the JAX host engine.
- The device candidate mask: a superset of the host f64 mask, and equal to
  the JAX device mask except on rows whose ANI lies within _DEV_ANI_MARGIN
  of the floor (f32 pow/exp round differently in torch and XLA there).
- Isolation: nothing under sylph_tpu_torch/, nor chip_smoke.py, imports jax
  or sylph_tpu; asking for CUDA without a GPU raises.
"""

import ast
import gzip
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.engine.prefilter import candidate_mask
from sylph_tpu.engine.prefilter import \
    candidate_mask_device as jax_mask_device
from sylph_tpu.engine.runner import ContainOptions, contain
from sylph_tpu.engine.sketch_cmd import SketchOptions, sketch
from sylph_tpu_torch import cli
from sylph_tpu_torch.engine import prefilter as tpf
from sylph_tpu_torch.engine import runner
from sylph_tpu_torch.engine.device_exec import DeviceContainment
from sylph_tpu_torch.gpu.grange import resolve_device
from tests.test_prefilter import _closest_adjusted_cases, _closest_naive_cases

torch.set_num_threads(1)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_grange.py::test_grange_cli_parity's world: 80 random
    20 kb genomes, reads from three of them at coverages 2, 0.35 and 6."""
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(21)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_genomes, glen = 80, 20_000
    genomes, paths = [], []
    for g in range(n_genomes):
        seq = rng.integers(0, 4, size=glen).astype(np.uint8)
        genomes.append(seq)
        p = d / f"g{g:03d}.fa.gz"
        with gzip.open(p, "wb") as f:
            f.write(b">genome%03d\n" % g + bases[seq].tobytes() + b"\n")
        paths.append(str(p))
    reads = []
    for t, cov in [(3, 2.0), (40, 0.35), (77, 6.0)]:
        src = genomes[t]
        for s in rng.integers(0, glen - 150, size=int(glen * cov / 150)):
            reads.append(src[s:s + 150].copy())
    rf = d / "sample.fq"
    with open(rf, "wb") as f:
        for i in rng.permutation(len(reads)):
            f.write(b"@r%d\n" % i + bases[reads[i]].tobytes()
                    + b"\n+\n" + b"I" * 150 + b"\n")
    sketch(SketchOptions(files=[], genomes=paths, reads=[str(rf)],
                         db_out_name=str(d / "db"), sample_output_dir=str(d),
                         c=25, k=31, threads=4))
    return d


@pytest.mark.parametrize("mode", ["profile", "query"])
def test_cli_tsv_byte_identical_to_jax(world, mode, monkeypatch):
    db, smp = str(world / "db.syldb"), str(world / "sample.fq.sylsp")
    want = io.StringIO()
    contain(ContainOptions(files=[db, smp], tpu=False),
            pseudotax=(mode == "profile"), out=want)
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    out = world / f"port_{mode}.tsv"
    assert cli.main([mode, db, smp, "--device", "cpu", "-o", str(out)]) == 0
    got = out.read_text()
    assert got == want.getvalue()
    assert len(got.strip().splitlines()) > 1


def test_cli_raw_reads_raise(world, tmp_path):
    """Raw inputs of both kinds are sketched now: ``profile db.syldb
    g077.fa.gz sample.fq.sylsp sample.fq`` (a genome fasta beside the
    database, a sketch and raw reads; merge regime) gives the JAX host
    engine's TSV byte for byte."""
    files = [str(world / f) for f in ("db.syldb", "g077.fa.gz",
                                      "sample.fq.sylsp", "sample.fq")]
    want = io.StringIO()
    contain(ContainOptions(files=files, c=25, tpu=False), pseudotax=True,
            out=want)
    out = tmp_path / "out.tsv"
    assert cli.main(["profile", *files, "-c", "25", "--device", "cpu", "-o",
                     str(out)]) == 0
    assert out.read_text() == want.getvalue()
    assert "g077.fa.gz" in want.getvalue()


_TF = os.path.join(_REPO, "test_files")


@pytest.fixture(scope="module")
def ecoli_db(tmp_path_factory):
    """A .syldb of the three test_files/ E. coli genomes at c=100, sketched
    by the JAX package."""
    d = tmp_path_factory.mktemp("ecoli_db")
    sketch(SketchOptions(files=[], genomes=[
        os.path.join(_TF, f"e.coli-{g}.fasta.gz")
        for g in ("EC590", "K12", "o157")], db_out_name=str(d / "db"),
        c=100, threads=3))
    return str(d / "db.syldb")


@pytest.mark.parametrize("mode", ["profile", "query"])
@pytest.mark.parametrize("reads", ["single", "paired"])
def test_cli_raw_reads_tsv_byte_identical_to_jax(ecoli_db, mode, reads,
                                                 tmp_path, monkeypatch):
    if reads == "single":
        opts = dict(files=[ecoli_db,
                           os.path.join(_TF, "o157_reads.fastq.gz")])
        argv = [ecoli_db, os.path.join(_TF, "o157_reads.fastq.gz")]
    else:
        r1, r2 = (os.path.join(_TF, f"k12_R{i}.fq") for i in (1, 2))
        opts = dict(files=[ecoli_db], first_pair=[r1], second_pair=[r2])
        argv = [ecoli_db, "-1", r1, "-2", r2]
    want = io.StringIO()
    contain(ContainOptions(c=100, tpu=False, **opts),
            pseudotax=(mode == "profile"), out=want)
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    out = tmp_path / "out.tsv"
    assert cli.main([mode, *argv, "-c", "100", "--device", "cpu", "-o",
                     str(out)]) == 0
    got = out.read_text()
    assert got == want.getvalue()
    assert len(got.strip().splitlines()) > 1


@pytest.mark.parametrize("mode", ["profile", "query"])
def test_cli_raw_reads_device_view_tsv(world, mode, monkeypatch):
    """Raw reads against the 80-genome world (enough genomes for the
    device prefilter): the sample streams into a device view, the stream
    sweep returns the candidate mask, and the TSV is byte-identical to the
    JAX host engine's on the same raw reads."""
    db, rf = str(world / "db.syldb"), str(world / "sample.fq")
    want = io.StringIO()
    contain(ContainOptions(files=[db, rf], c=25, tpu=False),
            pseudotax=(mode == "profile"), out=want)
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    engines = []
    make = runner._device_engine_for
    monkeypatch.setattr(runner, "_device_engine_for", lambda *a, **kw:
                        engines.append(make(*a, **kw)) or engines[-1])
    out = world / f"port_raw_{mode}.tsv"
    assert cli.main([mode, db, rf, "-c", "25", "--device", "cpu", "-o",
                     str(out)]) == 0
    assert out.read_text() == want.getvalue()
    assert len(want.getvalue().strip().splitlines()) > 1
    counters = engines[0]._grange.counters
    assert counters["device_view_sorts"] >= 1
    assert counters["mask_stream_masks"] == 1


def test_cli_raw_reads_library_failure_raises(world, monkeypatch):
    """A native library that will not load fails the run: the raw-read
    sample is not skipped as an invalid file with exit 0."""
    from sylph_tpu_torch.utils import cbuild

    def broken_load(*args, **kwargs):
        raise OSError("libfastxio.so: cannot open shared object file")

    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    monkeypatch.setattr(cbuild, "load", broken_load)
    with pytest.raises(OSError, match="cannot open shared object"):
        cli.main(["profile", str(world / "db.syldb"), str(world / "sample.fq"),
                  "-c", "25", "--device", "cpu"])


def test_small_database_regimes_not_ported(world, tmp_path):
    """The small-database regimes are ported: ``query`` of the 80-genome
    world, with no GRANGE_MIN patch, runs in the merge regime and gives the
    JAX host engine's TSV byte for byte."""
    files = [str(world / "db.syldb"), str(world / "sample.fq.sylsp")]
    want = io.StringIO()
    contain(ContainOptions(files=files, tpu=False), pseudotax=False,
            out=want)
    out = tmp_path / "out.tsv"
    assert cli.main(["query", *files, "--device", "cpu", "-o",
                     str(out)]) == 0
    assert out.read_text() == want.getvalue()
    assert len(want.getvalue().strip().splitlines()) > 1


# ---- multi-sample cohorts --------------------------------------------------

@pytest.fixture(scope="module")
def cohort(world):
    """Two more read sets of the 80-genome world (genomes 10 and 55, 3 and
    64, at coverages 3 / 1.5 and 1 / 4), sketched by the JAX package into
    s1.fq.sylsp and s2.fq.sylsp; s2 sketched at c=50 too, above the
    database's c=25, so that it is skipped when it loads; and a .sylsp
    that is not a sketch."""
    rng = np.random.default_rng(22)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for name, picks in (("s1", ((10, 3.0), (55, 1.5))),
                        ("s2", ((3, 1.0), (64, 4.0)))):
        seqs = []
        for g, cov in picks:
            with gzip.open(world / f"g{g:03d}.fa.gz", "rb") as f:
                src = f.read().split(b"\n")[1]
            for s in rng.integers(0, len(src) - 150,
                                  size=int(len(src) * cov / 150)):
                seqs.append(src[s:s + 150])
        rf = world / f"{name}.fq"
        with open(rf, "wb") as f:
            for i in rng.permutation(len(seqs)):
                f.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i], b"I" * 150))
        reads.append(str(rf))
    sketch(SketchOptions(files=[], reads=reads, sample_output_dir=str(world),
                         c=25, k=31, threads=2))
    (world / "c50").mkdir()
    sketch(SketchOptions(files=[], reads=reads[1:],
                         sample_output_dir=str(world / "c50"), c=50, k=31,
                         threads=2))
    (world / "bad.sylsp").write_bytes(b"not a sketch\n" * 10)
    return {n: str(p) for n, p in (
        ("db", world / "db.syldb"), ("raw", world / "sample.fq"),
        ("sk", world / "sample.fq.sylsp"), ("s1", world / "s1.fq.sylsp"),
        ("s2", world / "s2.fq.sylsp"), ("s2_raw", world / "s2.fq"),
        ("c50", world / "c50" / "s2.fq.sylsp"),
        ("bad", world / "bad.sylsp"))}


def _jax_tsv(files, mode):
    want = io.StringIO()
    contain(ContainOptions(files=files, c=25, tpu=False),
            pseudotax=(mode == "profile"), out=want)
    return want.getvalue()


def _port_tsv(files, mode, tmp_path, monkeypatch):
    """(TSV, the call's device engine) of the port's CLI on ``files``."""
    engines = []
    make = runner._device_engine_for
    monkeypatch.setattr(runner, "_device_engine_for", lambda *a, **kw:
                        engines.append(make(*a, **kw)) or engines[-1])
    out = tmp_path / f"{mode}.tsv"
    assert cli.main([mode, *files, "-c", "25", "--device", "cpu", "-o",
                     str(out)]) == 0
    return out.read_text(), engines[0]


def _small_chunks(monkeypatch):
    """Grange forced, the index cut into chunks of 64 buckets: at the
    default 2^25-slot chunks this small index leaves most columns empty and
    the code streams fail their capacity checks (exact still, through the
    per-sample path), which would hide the batched sweep."""
    import functools

    from sylph_tpu_torch.engine import device_exec
    from sylph_tpu_torch.gpu import grange as tgr
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    monkeypatch.setattr(device_exec, "build_grange_index", functools.partial(
        tgr.build_grange_index, chunk_slots=1 << 14, target_mean=256))


@pytest.mark.parametrize("mode", ["profile", "query"])
def test_cli_cohort_merge_default_depth(cohort, mode, tmp_path, monkeypatch):
    """Raw reads and three sketches in the merge regime at the default
    depth (8): one batched join for the four samples, TSVs byte-identical
    to the JAX host engine's."""
    monkeypatch.delenv("SYLPH_COHORT_DEPTH", raising=False)
    files = [cohort[x] for x in ("db", "s1", "raw", "sk", "s2")]
    want = _jax_tsv(files, mode)
    got, eng = _port_tsv(files, mode, tmp_path, monkeypatch)
    assert got == want
    assert eng._grange is None and eng.counters["batched_joins"] == 1
    # sample.fq and its sketch report under one name
    assert len({r.split("\t")[0] for r in want.splitlines()[1:]}) == 3


@pytest.mark.parametrize("mode", ["profile", "query"])
def test_cli_cohort_grange_depth3(cohort, mode, tmp_path, monkeypatch):
    """Grange forced at SYLPH_COHORT_DEPTH=3 over three sketches: one
    batched sweep, no per-sample sweep, TSVs byte-identical to the JAX
    host engine's."""
    _small_chunks(monkeypatch)
    monkeypatch.setenv("SYLPH_COHORT_DEPTH", "3")
    files = [cohort[x] for x in ("db", "sk", "s1", "s2")]
    want = _jax_tsv(files, mode)
    got, eng = _port_tsv(files, mode, tmp_path, monkeypatch)
    assert got == want
    c = eng._grange.counters
    assert (c["batched_sweeps"], c["batched_rejected"], c["hists_sweeps"],
            c["mask_stream_masks"]) == (1, 0, 0, 0)
    assert len({r.split("\t")[0] for r in want.splitlines()[1:]}) == 3


def test_cli_cohort_grange_depth1_mixed(cohort, tmp_path, monkeypatch):
    """Grange forced at the default depth (1): raw reads (streamed to the
    device view) and sketches mixed, each sample loading while the one
    before it is processed; TSV byte-identical to the JAX host engine's."""
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    monkeypatch.delenv("SYLPH_COHORT_DEPTH", raising=False)
    files = [cohort[x] for x in ("db", "s1", "raw", "sk", "s2_raw")]
    want = _jax_tsv(files, "profile")
    got, eng = _port_tsv(files, "profile", tmp_path, monkeypatch)
    assert got == want
    c = eng._grange.counters
    assert c["batched_sweeps"] == 0 and c["device_view_sorts"] >= 2
    assert len({r.split("\t")[0] for r in want.splitlines()[1:]}) == 3


def test_cli_cohort_bad_sylsp_exits_1(cohort, monkeypatch):
    """A file that is not a sketch in the middle of a cohort: the error
    raised on the load thread still fails the run with exit 1."""
    monkeypatch.setenv("SYLPH_COHORT_DEPTH", "2")
    files = [cohort[x] for x in ("db", "sk", "s1", "bad", "s2")]
    with pytest.raises(SystemExit):
        _jax_tsv(files, "profile")
    assert cli.main(["profile", *files, "--device", "cpu"]) == 1


def test_cli_cohort_skipped_sample_keeps_order(cohort, tmp_path,
                                               monkeypatch):
    """A sketch at a c above the database's is skipped where it stands;
    the others keep their order and the TSV is the JAX host engine's."""
    _small_chunks(monkeypatch)
    monkeypatch.setenv("SYLPH_COHORT_DEPTH", "3")
    files = [cohort[x] for x in ("db", "s2", "c50", "sk", "s1")]
    want = _jax_tsv(files, "query")
    got, eng = _port_tsv(files, "query", tmp_path, monkeypatch)
    assert got == want
    # cohorts (s2, c50, sample) and (s1): one batched sweep of the first
    # cohort's two loaded samples, one per-sample sweep of s1
    c = eng._grange.counters
    assert (c["batched_sweeps"], c["hists_sweeps"]) == (1, 1)
    names = [os.path.basename(r.split("\t")[0])
             for r in want.splitlines()[1:]]
    assert list(dict.fromkeys(names)) == ["s2.fq", "sample.fq", "s1.fq"]


def test_cuda_without_gpu_raises(world, monkeypatch):
    """No silent fallback: without a GPU, asking for CUDA (the default of
    every entry point) raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DeviceContainment([])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["profile", str(world / "db.syldb"),
                  str(world / "sample.fq.sylsp")])


# ---- the device candidate mask ---------------------------------------------

def _random_hists(seed, G=400):
    """tests/test_prefilter.py::test_candidate_mask_device_superset's
    world: absent, low-lambda, high-coverage and median<=2 rows."""
    rng = np.random.default_rng(seed)
    n_kmers = rng.integers(30, 4000, size=G)
    hist = np.zeros((G, 64), np.int64)
    for g in range(G):
        kind = rng.integers(0, 4)
        nk = int(n_kmers[g])
        if kind == 1:
            covs = rng.poisson(rng.uniform(0.05, 2.0), size=nk)
            covs = covs[covs > 0]
        elif kind == 2:
            covs = rng.poisson(rng.uniform(3, 40),
                               size=rng.integers(1, nk + 1)) + 1
        elif kind == 3:
            covs = rng.integers(1, 3, size=rng.integers(1, max(2, nk)))
        else:
            covs = np.empty(0, np.int64)
        if covs.size:
            hist[g] += np.bincount(np.minimum(covs, 63), minlength=64)
    return hist, n_kmers


def _near_floor_hists(floor):
    """tests/test_prefilter.py's adversarial rows: naive and adjusted ANI
    within ulps of the floor."""
    rows, nks = [], []
    for c, n, _d in _closest_naive_cases(floor):
        row = np.zeros(64, np.int64)
        row[3] = c
        rows.append(row)
        nks.append(n)
    for c1, c2, n, _d in _closest_adjusted_cases(floor):
        row = np.zeros(64, np.int64)
        row[1], row[2] = c1, c2
        rows.append(row)
        nks.append(n)
    return np.stack(rows), np.asarray(nks, np.int64)


def _row_anis(hist, n_kmers, k=31):
    """f64 naive ANI per row and, for the ratio-lambda rows (values 1 and
    2 only, as in the near-floor cases), the adjusted ANI."""
    contained = hist[:, 1:].sum(axis=1)
    naive = (contained / np.maximum(n_kmers, 1)) ** (1.0 / k)
    c1, c2 = hist[:, 1].astype(np.float64), hist[:, 2].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        lam = c2 / c1 * 2.0
        adj = (contained / -np.expm1(-lam) / n_kmers) ** (1.0 / k)
    return naive, adj


def _masks(hist, n_kmers, min_ani):
    kw = dict(k=31, min_ani=min_ani, min_number_kmers=50.0,
              min_count_correct=3.0, no_adj=False)
    host = candidate_mask(hist, n_kmers, **kw)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jax_mask_device(
            jnp.asarray(hist.astype(np.int32)),
            jnp.asarray(n_kmers.astype(np.int32)), **kw))
    got = tpf.candidate_mask_device(
        torch.from_numpy(hist.astype(np.int32)),
        torch.from_numpy(n_kmers.astype(np.int32)), **kw).numpy()
    return host, ref, got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_mask_superset_and_equal_to_jax(seed):
    hist, n_kmers = _random_hists(seed)
    for min_ani in (0.5, 0.90, 0.95):
        host, ref, got = _masks(hist, n_kmers, min_ani)
        assert not (host & ~got).any()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("floor", [0.90, 0.95])
def test_device_mask_near_floor(floor):
    """At the floor itself the two f32 masks may disagree, but only on
    rows whose f64 ANI lies within _DEV_ANI_MARGIN of the floor (tolerance:
    the f32 margin that keeps the device mask a superset of the host's);
    the port still keeps every host candidate."""
    hist, n_kmers = _near_floor_hists(floor)
    host, ref, got = _masks(hist, n_kmers, floor)
    assert not (host & ~got).any()
    naive, adj = _row_anis(hist, n_kmers)
    near = ((np.abs(naive - floor) <= tpf._DEV_ANI_MARGIN)
            | (np.abs(adj - floor) <= tpf._DEV_ANI_MARGIN))
    assert near.all()           # every adversarial row sits at the floor
    assert (got == ref)[~near].all()


# ---- isolation -------------------------------------------------------------

def _port_sources():
    root = os.path.join(_REPO, "sylph_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(_REPO, "chip_smoke.py")


# the JAX package, JAX itself, and the JAX side's root modules and scripts
_FORBIDDEN = ("jax", "jaxlib", "sylph_tpu", "bench", "__graft_entry__",
              "scripts")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in _FORBIDDEN


def test_port_sources_import_no_jax_or_jax_package():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sylph_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r}]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_c_sources_include_only_their_own_headers():
    """The port's C and CUDA sources include system headers and their own
    csrc/common.cuh, never a file of the JAX package."""
    bad = []
    for sub in ("native", "csrc"):
        d = os.path.join(_REPO, "sylph_tpu_torch", sub)
        for f in sorted(os.listdir(d)):
            with open(os.path.join(d, f)) as fh:
                for i, line in enumerate(fh, 1):
                    s = line.strip()
                    if s.startswith("#include") and '"' in s and \
                            s != '#include "common.cuh"':
                        bad.append(f"{sub}/{f}:{i}: {s}")
    assert not bad, bad


def test_port_loads_no_library_of_the_jax_package(tmp_path):
    """Sketching through the port builds and loads its own copies of the
    host C libraries, under build/native/, and maps nothing of the JAX
    package's native/ directory."""
    code = (
        "import os, sys, torch\n"
        "from sylph_tpu_torch.core.sketch_reads import sketch_pair_sequences\n"
        "from sylph_tpu_torch.utils import cbuild\n"
        "tf = os.path.join('test_files', '')\n"
        "sk = sketch_pair_sequences(tf + 't1.fq', tf + 't2.fq', 5, 21,\n"
        "                           device=torch.device('cpu'))\n"
        "assert sk.kmers.size > 0\n"
        "maps = open('/proc/self/maps').read()\n"
        "jax_native = os.path.join(os.getcwd(), 'native') + os.sep\n"
        "ours = os.path.join(os.getcwd(), 'build', 'native') + os.sep\n"
        "assert cbuild.BUILD_DIR + os.sep == ours, cbuild.BUILD_DIR\n"
        "assert jax_native not in maps\n"
        "assert maps.count(ours + 'libsketchcore-') and \\\n"
        "    maps.count(ours + 'libfastxio-')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sylph_tpu')]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
