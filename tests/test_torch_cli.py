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


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "sylph_tpu")


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
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sylph_tpu')]\n"
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
