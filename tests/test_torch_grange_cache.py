"""The grange layout disk cache (``SYLPH_GRANGE_CACHE``) of the port's
device engine, on the CPU, with the grange regime forced on a small
database by patching ``DeviceContainment.GRANGE_MIN`` (as
tests/test_grange.py:227 does).

- A cached load equals a fresh build field by field: every tensor
  ``torch.equal``, every array equal in value and type, every int equal.
- ``profile`` with the cache gives the TSV it gives without it, on the call
  that saves the layout and on the call that loads it; the first builds,
  the second does not.
- A database with the same genome count and total k-mers but other
  content rebuilds and does not load the stale layout; a save cut before
  its metadata file is never loaded.
- The directory cannot collide with the JAX package's cache layout of the
  same database.
"""

import os

import numpy as np
import pytest
import torch

from sylph_tpu.engine import device_exec as jde
from sylph_tpu_torch import cli
from sylph_tpu_torch.core.types import GenomeSketch, SequencesSketch
from sylph_tpu_torch.engine import device_exec as tde
from sylph_tpu_torch.engine.device_exec import DeviceContainment
from sylph_tpu_torch.gpu.grange import GRangeIndex, build_grange_index
from sylph_tpu_torch.io import sylformat

torch.set_num_threads(1)
C, K = 200, 31
G, KPG = 60, 1500


def _genomes(seed):
    rng = np.random.default_rng(seed)
    thr = ((1 << 64) - 1) // C
    kmers = rng.integers(0, thr, size=G * KPG, dtype=np.uint64)
    empty = np.empty(0, np.uint64)
    return [GenomeSketch(kmers[i * KPG:(i + 1) * KPG], empty, f"g{i:03d}.fa",
                         f"contig{i}", C, K, KPG * C, 30) for i in range(G)]


def _sample(genomes, seed):
    """Six genomes planted whole at multiplicities about 3, plus 5,000
    hashes absent from the database."""
    rng = np.random.default_rng(seed)
    picks = rng.choice(G, size=6, replace=False)
    km = [genomes[g].genome_kmers for g in picks]
    km.append(rng.integers(0, ((1 << 64) - 1) // C, size=5000,
                           dtype=np.uint64))
    kmers = np.concatenate(km)
    counts = (rng.poisson(3.0, size=kmers.size) + 1).astype(np.uint32)
    return SequencesSketch(kmers, counts, C, K, "sample.fq", None, False,
                           150.0)


@pytest.fixture
def world(tmp_path, monkeypatch):
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    monkeypatch.delenv("SYLPH_GRANGE_CACHE", raising=False)
    genomes = _genomes(1)
    db, smp = str(tmp_path / "db.syldb"), str(tmp_path / "s.sylsp")
    sylformat.write_syldb(db, genomes)
    sylformat.write_sylsp(smp, _sample(genomes, 2))
    return tmp_path, genomes, db, smp


def _builds(monkeypatch):
    """Count the engine's layout builds."""
    n = [0]
    real = tde.build_grange_index

    def spy(*a, **kw):
        n[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(tde, "build_grange_index", spy)
    return n


def _assert_same_layout(a: GRangeIndex, b: GRangeIndex):
    for name in GRangeIndex._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, list):
            assert len(x) == len(y), name
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and torch.equal(u, v), name
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert type(x) is type(y) and x == y, name


def _fresh(genomes):
    kmers = np.concatenate([g.genome_kmers for g in genomes])
    gids = np.repeat(np.arange(G, dtype=np.int32), KPG)
    return build_grange_index(kmers, gids, G, device="cpu")


def test_cached_load_equals_build(world, monkeypatch):
    tmp, genomes, _, _ = world
    monkeypatch.setenv("SYLPH_GRANGE_CACHE", str(tmp / "cache"))
    builds = _builds(monkeypatch)
    saved = DeviceContainment(genomes, device="cpu")._grange.gidx
    assert builds[0] == 1
    (d,) = os.listdir(tmp / "cache")
    assert d.startswith("torch_grange_60_90000_")
    assert os.path.exists(tmp / "cache" / d / "meta.npz")
    loaded = DeviceContainment(genomes, device="cpu")._grange.gidx
    assert builds[0] == 1
    assert loaded.chunk_keys[0].dtype == torch.int64
    assert loaded.chunk_gid[0].dtype == torch.int32
    _assert_same_layout(loaded, saved)
    _assert_same_layout(loaded, _fresh(genomes))


def test_profile_tsv_unchanged_by_the_cache(world, monkeypatch):
    tmp, _, db, smp = world
    builds = _builds(monkeypatch)

    def run(name):
        out = tmp / f"{name}.tsv"
        assert cli.main(["profile", db, smp, "--device", "cpu", "-o",
                         str(out)]) == 0
        return out.read_text()

    plain = run("plain")
    assert builds[0] == 1 and len(plain.strip().splitlines()) == 7
    monkeypatch.setenv("SYLPH_GRANGE_CACHE", str(tmp / "cache"))
    assert run("save") == plain
    assert builds[0] == 2
    assert run("load") == plain
    assert builds[0] == 2


def test_changed_database_rebuilds(world, monkeypatch):
    tmp, genomes, _, _ = world
    monkeypatch.setenv("SYLPH_GRANGE_CACHE", str(tmp / "cache"))
    builds = _builds(monkeypatch)
    first = DeviceContainment(genomes, device="cpu")._grange.gidx
    other = _genomes(3)            # same counts, other k-mers
    assert sum(g.genome_kmers.size for g in other) == G * KPG
    got = DeviceContainment(other, device="cpu")._grange.gidx
    assert builds[0] == 2
    assert len(os.listdir(tmp / "cache")) == 2
    _assert_same_layout(got, _fresh(other))
    assert not torch.equal(got.chunk_keys[0], first.chunk_keys[0])


def test_save_without_metadata_is_not_loaded(world, monkeypatch):
    tmp, genomes, _, _ = world
    monkeypatch.setenv("SYLPH_GRANGE_CACHE", str(tmp / "cache"))
    builds = _builds(monkeypatch)
    DeviceContainment(genomes, device="cpu")
    (d,) = os.listdir(tmp / "cache")
    os.remove(tmp / "cache" / d / "meta.npz")     # as a cut save leaves it
    again = DeviceContainment(genomes, device="cpu")._grange.gidx
    assert builds[0] == 2
    _assert_same_layout(again, _fresh(genomes))


def test_cache_name_apart_from_the_jax_cache(world):
    tmp, genomes, _, _ = world
    total = G * KPG
    port = tde._grange_cache_path(str(tmp), total, genomes)
    jax = jde._grange_cache_path(str(tmp), total, G,
                                 jde._grange_fingerprint(genomes))
    assert tde._grange_fingerprint(genomes) == \
        jde._grange_fingerprint(genomes)
    assert os.path.basename(port) == "torch_" + os.path.basename(jax)
