"""The port's library API (sylph_tpu_torch/api.py) against the JAX
package's (sylph_tpu/api.py), on the CPU: the port of tests/test_api.py.

Each case runs the port's function with ``device="cpu"`` and the JAX api
with ``tpu=False`` on the same fixtures (the three test_files/ E. coli
genomes and the o157 reads, sketched by the JAX package) and compares the
``ProfileRow`` fields exactly. Beside them: the port's own sketches equal
the JAX package's; ``Profiler`` called repeatedly builds one engine and
takes a path; a ``--disable-profiling`` database raises ``ValueError``;
without a GPU ``Profiler(db)`` and the default ``device="cuda"`` raise
(the JAX ``_engine`` falls back to the host engine, api.py:125-129).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import sylph_tpu.api as japi
import sylph_tpu_torch.api as sylph
from sylph_tpu_torch.engine import device_exec

torch.set_num_threads(1)
TF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "test_files")
_GENOMES = [f"{TF}/e.coli-{g}.fasta.gz" for g in ("EC590", "K12", "o157")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX db, JAX sample, the port's db and sample loaded from the JAX
    package's files)."""
    d = tmp_path_factory.mktemp("api")
    jdb = japi.sketch_genomes(_GENOMES)
    jsample = japi.sketch_reads(f"{TF}/o157_reads.fastq.gz")
    japi.save_db(str(d / "db.syldb"), jdb)
    japi.save_sample(str(d / "s.sylsp"), jsample)
    return (jdb, jsample, sylph.load_db(str(d / "db.syldb")),
            sylph.load_sample(str(d / "s.sylsp")))


def _fields(rows):
    return [dataclasses.astuple(r) for r in rows]


def test_profile_api(world):
    jdb, jsample, db, sample = world
    rows = sylph.profile(db, sample, device="cpu")
    assert _fields(rows) == _fields(japi.profile(jdb, jsample, tpu=False))
    assert len(rows) == 1
    r = rows[0]
    assert "o157" in r.genome
    assert r.rel_abundance == pytest.approx(100.0)
    assert r.adjusted_ani == pytest.approx(100.0, abs=0.5)
    assert r.eff_cov == pytest.approx(0.338, abs=0.01)


def test_query_api(world):
    jdb, jsample, db, sample = world
    rows = sylph.query(db, sample, device="cpu")
    assert _fields(rows) == _fields(japi.query(jdb, jsample, tpu=False))
    assert len(rows) == 3
    assert rows[0].adjusted_ani >= rows[-1].adjusted_ani
    assert rows[0].kmers_reassigned is None


@pytest.mark.parametrize("kw", [dict(min_ani=99.0),
                                dict(estimate_unknown=True),
                                dict(seq_id=99.5)])
def test_query_and_profile_options_match_jax(world, kw):
    jdb, jsample, db, sample = world
    for port, jax_fn in ((sylph.query, japi.query),
                         (sylph.profile, japi.profile)):
        assert _fields(port(db, sample, device="cpu", **kw)) == \
            _fields(jax_fn(jdb, jsample, tpu=False, **kw))


def test_sketches_match_jax(world):
    """sketch_genomes and sketch_reads seeded on the CPU give the JAX
    package's sketches."""
    jdb, jsample, _, _ = world
    db = sylph.sketch_genomes(_GENOMES, device="cpu")
    assert [g.file_name for g in db] == [g.file_name for g in jdb]
    for a, b in zip(db, jdb):
        np.testing.assert_array_equal(a.genome_kmers, b.genome_kmers)
        np.testing.assert_array_equal(a.pseudotax_tracked_nonused_kmers,
                                      b.pseudotax_tracked_nonused_kmers)
    s = sylph.sketch_reads(f"{TF}/o157_reads.fastq.gz", device="cpu")
    np.testing.assert_array_equal(s.kmers, jsample.kmers)
    np.testing.assert_array_equal(s.counts, jsample.counts)
    pair = sylph.sketch_reads(f"{TF}/k12_R1.fq", f"{TF}/k12_R2.fq",
                              device="cpu")
    jpair = japi.sketch_reads(f"{TF}/k12_R1.fq", f"{TF}/k12_R2.fq")
    np.testing.assert_array_equal(pair.kmers, jpair.kmers)
    np.testing.assert_array_equal(pair.counts, jpair.counts)


def test_roundtrip_io(world, tmp_path):
    _, _, db, sample = world
    sylph.save_db(str(tmp_path / "x.syldb"), db)
    db2 = sylph.load_db(str(tmp_path / "x.syldb"))
    assert len(db2) == len(db)
    assert (db2[0].genome_kmers == db[0].genome_kmers).all()
    sylph.save_sample(str(tmp_path / "x.sylsp"), sample)
    s2 = sylph.load_sample(str(tmp_path / "x.sylsp"))
    assert (np.sort(s2.kmers) == np.sort(sample.kmers)).all()


def _disabled():
    db = sylph.sketch_genomes([f"{TF}/e.coli-K12.fasta.gz"],
                              enable_profiling=False, device="cpu")
    sample = sylph.sketch_reads(f"{TF}/t1.fq", c=5, k=31, device="cpu")
    return db, sample


def test_profile_rejects_disabled_db():
    db, sample = _disabled()
    with pytest.raises(ValueError):
        sylph.profile(db, sample, device="cpu")
    prof = sylph.Profiler(db, device="cpu")
    with pytest.raises(ValueError):
        prof.profile(sample)
    assert prof.query(sample) == sylph.query(db, sample, device="cpu")


def _count_engines(monkeypatch):
    n = [0]
    real = device_exec.DeviceContainment.__init__

    def init(self, *a, **kw):
        n[0] += 1
        real(self, *a, **kw)
    monkeypatch.setattr(device_exec.DeviceContainment, "__init__", init)
    return n


def test_profiler_handle(world, monkeypatch):
    """Profiler: one engine, built once, serves repeated profile/query
    calls with the one-shot api's rows, which equal the JAX api's."""
    jdb, jsample, db, sample = world
    want_p = _fields(japi.profile(jdb, jsample, tpu=False))
    want_q = _fields(japi.query(jdb, jsample, tpu=False))
    built = _count_engines(monkeypatch)
    prof = sylph.Profiler(db, device="cpu")
    for _ in range(2):           # repeated calls hit the same engine
        assert _fields(prof.profile(sample)) == want_p
        assert _fields(prof.query(sample)) == want_q
    assert built[0] == 1
    assert _fields(japi.Profiler(jdb, tpu=False).profile(jsample)) == want_p


def test_profiler_path_input(world, tmp_path):
    jdb, jsample, db, sample = world
    p = str(tmp_path / "s.sylsp")
    sylph.save_sample(p, sample)
    prof = sylph.Profiler(db, device="cpu")
    want = _fields(japi.profile(jdb, jsample, tpu=False))
    assert _fields(prof.profile(p)) == want
    # a raw-read path is sketched on the profiler's device
    assert _fields(prof.profile(f"{TF}/o157_reads.fastq.gz")) == want


def test_no_gpu_raises(world, monkeypatch):
    """device="cuda" (the default) without a GPU raises at once: no
    fall-back to the CPU."""
    _, _, db, sample = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sylph.Profiler(db)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sylph.profile(db, sample)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sylph.sketch_reads(f"{TF}/t1.fq")
