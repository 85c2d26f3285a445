"""The port's dev tools (sylph_tpu_torch.{host_golden, gbench, dupskew,
profile_ingest, stage_timing, e2e_debug}) against the JAX side's scripts
and package on the CPU, at tiny sizes:

- host_golden's TSV equals the JAX host engine's ``contain(ContainOptions(
  files=[db, reads], threads=4))`` (scripts/gtdb_cli_host_golden.py), and
  its comparison run on the CPU agrees;
- dupskew's ``gen_dup_index`` gives scripts/dupskew.py's bytes, its
  layouts JAX's ``build_grange_index`` fields (CI, tile, ov, spill, lane,
  heavy runs) at nt 1 and 4, and every histogram its brute-force oracle;
- gbench's variants each give ``full``'s histogram and ``full`` the oracle;
- profile_ingest's phased sketch equals the host seeder's, stage_timing's
  stages agree, e2e_debug's instrumented TSV equals the plain one;
- each tool's main() runs with ``--device cpu`` and raises without a GPU
  otherwise.
"""

import functools
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

import sylph_tpu.tpu.grange as jgr
from sylph_tpu.engine.runner import ContainOptions as JOptions
from sylph_tpu.engine.runner import contain as jcontain
from sylph_tpu_torch import (dupskew, e2e_debug, gbench, host_golden,
                             profile_ingest, stage_timing)
from sylph_tpu_torch.gpu import synth_index as si
from tests.test_torch_multidevice import make_o157_world

torch.set_num_threads(1)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TF = os.path.join(_REPO, "test_files")
_READS = os.path.join(_TF, "o157_reads.fastq.gz")
_R1, _R2 = os.path.join(_TF, "k12_R1.fq"), os.path.join(_TF, "k12_R2.fq")
_NO_GPU = not torch.cuda.is_available()


@pytest.fixture(scope="module")
def o157(tmp_path_factory):
    d = tmp_path_factory.mktemp("o157_tools")
    make_o157_world(d)
    return d


def _jax_script(name, monkeypatch):
    """scripts/<name>.py as a module; MALLOC_MMAP_THRESHOLD_ set, so its
    allocator re-exec does not fire at import."""
    monkeypatch.setenv("MALLOC_MMAP_THRESHOLD_", "17179869184")
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(_REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- host_golden -----------------------------------------------------------

@pytest.mark.parametrize("pair", [False, True])
def test_host_golden_matches_jax_host_engine(o157, tmp_path, pair):
    db = str(o157 / "db.syldb")
    reads = [_R1, _R2] if pair else [_READS]
    out = tmp_path / "golden_host.tsv"
    assert host_golden.main(["--db", db, "--reads", *reads, "--out",
                             str(out), "--device", "cpu"]) == 0
    want = io.StringIO()
    if pair:
        opts = JOptions(files=[db], first_pair=[_R1], second_pair=[_R2],
                        threads=4)
    else:
        opts = JOptions(files=[db, _READS], threads=4)
    jcontain(opts, pseudotax=True, out=want)
    assert out.read_text() == want.getvalue()
    assert len(want.getvalue().splitlines()) >= 2
    assert not os.path.exists(str(out) + ".tmp")


def test_host_golden_debug_logs_the_host_probes(o157, tmp_path, capsys):
    import logging
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        assert host_golden.main(["--db", str(o157 / "db.syldb"), "--reads",
                                 _READS, "--out", str(tmp_path / "g.tsv"),
                                 "--golden-only", "--debug"]) == 0
    finally:
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    err = capsys.readouterr().err
    assert "[timing] prefilter: host probes" in err
    assert "[timing] pass-2 reassigned stats" in err


# ---- dupskew ---------------------------------------------------------------

_PROFILES = ((0.0, 1), (2.0, 1000), (1.5, 100))


def test_gen_dup_index_matches_jax_script(monkeypatch):
    jd = _jax_script("dupskew", monkeypatch)
    for alpha, dmax in _PROFILES:
        got = dupskew.gen_dup_index(20_000, 700, alpha, dmax, seed=3)
        want = jd.gen_dup_index(20_000, 700, alpha, dmax, seed=3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("nt", [1, 4])
def test_layout_stats_match_jax_build(monkeypatch, nt):
    jd = _jax_script("dupskew", monkeypatch)
    rng = np.random.default_rng(7)
    for alpha, dmax in _PROFILES:
        km, gg, _d = dupskew.gen_dup_index(30_000, 500, alpha, dmax)
        gidx, st = dupskew.layout_stats(km, gg, 500, nt, "cpu",
                                        chunk_slots=1 << 14)
        ref = jgr.build_grange_index(km, gg, 500, presorted=True, nt=nt,
                                     chunk_slots=1 << 14)
        lane = (ref.tile + ref.ov) if ref.nt > 1 else ref.CI
        assert (st["nt"], st["CI"], st["tile"], st["ov"], st["spill"],
                st["lane"], st["heavy"]) == (
            ref.nt, ref.CI, ref.tile, ref.ov, int(ref.spill_kmers.size),
            lane, ref.n_heavy)
        skm = np.unique(np.concatenate([
            rng.choice(np.unique(km), 4000, replace=False),
            rng.integers(0, (1 << 64) // 200, 4000, dtype=np.uint64)]))
        sct = rng.integers(1, 8, skm.size).astype(np.uint32)
        oracle = dupskew.host_hist(km, gg, 500, skm, sct)
        np.testing.assert_array_equal(
            oracle, jd.host_hist(km, gg, 500, skm, sct))
        from sylph_tpu_torch.gpu.grange import GRangeEngine
        np.testing.assert_array_equal(
            GRangeEngine(gidx, device="cpu").hists(skm, sct), oracle)
        assert oracle[:, 1:].sum() > 0


def test_dupskew_parity_with_heavy_runs_and_spill(capsys):
    recs = dupskew.run(1 << 15, 500, "uniform,a2.0:d1000", (1, 4), 20_000,
                       1 << 12, "cpu", reps=1)
    assert len(recs) == 4
    assert all(r["parity"] == "OK" and r["dparity"] == "OK" for r in recs)
    assert any(r["heavy"] for r in recs) and any(r["spill"] for r in recs)
    assert "parity=OK" in capsys.readouterr().out


def test_dupskew_refuses_fewer_than_min_chunks():
    # the uniform index of 4,096 k-mers fills 4 chunks of 1,024 slots
    with pytest.raises(ValueError, match="fills 4 chunks"):
        dupskew.run(1 << 12, 300, "uniform", (1,), 2_000, 1 << 10, "cpu",
                    reps=1)


# ---- gbench ----------------------------------------------------------------

@pytest.fixture
def tiny_synth(monkeypatch):
    kw = dict(chunk_slots=1 << 16, target_mean=64)
    monkeypatch.setattr(si, "synth_index_device", functools.partial(
        si.synth_index_device, **kw))
    monkeypatch.setattr(si, "synth_plants_host", functools.partial(
        si.synth_plants_host, **kw))


@pytest.mark.parametrize("nt", ["1", "4"])
def test_gbench_variants_equal_full_and_oracle(tiny_synth, monkeypatch, nt):
    monkeypatch.setenv("SYLPH_NT", nt)
    out = gbench.run(genomes=80, reps=1, batches=4, reads=512, kpg=2000,
                     device="cpu", variants=[
                         "prefix", "joinonly", "joinstages", "dense80",
                         "fill", "seed_t", "fused2"])
    assert out["index"]["nt"] == int(nt)
    assert out["checks"]["oracle_hits"] > 0
    for tag in ("full", "joinonly", "joinonly(fill)", "full(fill)",
                "join:+compare", "join:+codes", "full(d0.80)",
                "full(seed_t)", "full(x2)"):
        assert out["checks"][tag] == "equal", tag
    for name in ("seed", "seed+condense", "seed+cond+sort", "full",
                 "join:prep", "join:fill", "join:+compare", "join:+codes",
                 "join:full", "seed(seed_t)", "seed(x2)"):
        assert out["lines"][name]["best_ms"] > 0, name
    assert out["lines"]["join:+compare"]["launches"] == {}  # the CPU


def test_gbench_host_index_and_oracle_mismatch_raises(tiny_synth,
                                                      monkeypatch, tmp_path):
    from sylph_tpu_torch import bench as tb
    from sylph_tpu_torch.gpu import grange as tgr
    monkeypatch.setattr(tb, "DATA", str(tmp_path))
    monkeypatch.setattr(tgr, "build_grange_index", functools.partial(
        tgr.build_grange_index, chunk_slots=1 << 14))
    out = gbench.run(genomes=48, reps=1, batches=2, reads=256, kpg=600,
                     index="host", device="cpu", variants=["joinonly"])
    assert out["checks"]["joinonly"] == "equal"
    monkeypatch.setattr(gbench, "oracle_hist",
                        lambda g, s, G: np.zeros((G, 64), np.int64))
    with pytest.raises(RuntimeError, match="oracle"):
        gbench.run(genomes=48, reps=1, batches=2, reads=256, kpg=600,
                   index="host", device="cpu", variants=[])


# ---- profile_ingest, stage_timing, e2e_debug ------------------------------

def test_profile_ingest_phases_equal_host_sketch():
    rec = profile_ingest.run(_READS, 2, "cpu")
    assert rec["equal"] and rec["kmers"] > 0
    for phase in ("build_batch", "pack16", "upload",
                  "seed (B7, compaction, B8)", "fetch+mask", "reorder",
                  "fingerprints", "fold"):
        assert phase in rec["warm"], phase


def test_profile_ingest_redoes_a_lossy_batch(monkeypatch):
    """A batch whose condensed stream lost survivors is redone uncondensed,
    as read_survivor_arrays does; the sketch still equals the host's."""
    from sylph_tpu_torch.engine import device_sketch as ds
    seed = ds._seed_packed

    def lossy(*args):
        stream, n_r = seed(*args)
        stream = stream.clone()
        stream[torch.nonzero(stream != -1)[0]] = -1
        return stream, n_r
    monkeypatch.setattr(ds, "_seed_packed", lossy)
    rec = profile_ingest.run(_READS, 1, "cpu")
    assert rec["equal"] and rec["batches"]["redone"] == \
        rec["batches"]["seeded"] > 0
    assert "redo (B7, compaction, fetch)" in rec["warm"]


def test_stage_timing_stages_agree():
    rec = stage_timing.run("cpu", reps=1, n=512)
    assert rec["survivors"] == rec["compacted"] > 0
    assert set(rec["stages"]) == {"plain seed", "B7 seed", "compact"}


# ---- every main(): --device cpu runs, the default needs a GPU --------------

def _mains(o157, tmp_path):
    db = str(o157 / "db.syldb")
    gb = ["--genomes", "80", "--kpg", "2000", "--batches", "2", "--reads",
          "256", "--reps", "1", "prefix"]
    ds = ["--unique", "16384", "--genomes", "300", "--sample", "8000",
          "--chunk-slots", "2048", "--profiles", "a2.0:d1000"]
    return [
        (gbench.main, gb),
        (dupskew.main, ds),
        (stage_timing.main, ["--reads", "256", "--reps", "1"]),
        (profile_ingest.main, ["--reads", _READS, "--blocks", "1"]),
        (e2e_debug.main, ["--db", db, "--reads", _READS, "--runs", "1"]),
        (e2e_debug.main, ["--db", db, "--paired", "--r1", _R1, "--r2", _R2,
                          "--runs", "1"]),
        (host_golden.main, ["--db", db, "--reads", _READS, "--out",
                            str(tmp_path / "g.tsv")]),
    ]


_TAGS = ("gbench", "dupskew", "stage_timing", "profile_ingest",
         "e2e_debug", "e2e_debug", "host_golden")


@pytest.mark.parametrize("i", range(len(_TAGS)),
                         ids=[f"{t}{i}" for i, t in enumerate(_TAGS)])
def test_mains_run_on_cpu(o157, tmp_path, tiny_synth, capsys, i):
    main, argv = _mains(o157, tmp_path)[i]
    assert main([*argv, "--device", "cpu"]) == 0
    assert f"{_TAGS[i]}: " in capsys.readouterr().out


@pytest.mark.skipif(not _NO_GPU, reason="a GPU is present")
def test_mains_raise_without_gpu(o157, tmp_path):
    for main, argv in _mains(o157, tmp_path):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(argv)
    # host_golden without a GPU writes its golden only when asked to
    assert host_golden.main(["--db", str(o157 / "db.syldb"), "--reads",
                             _READS, "--out", str(tmp_path / "g.tsv"),
                             "--golden-only"]) == 0
