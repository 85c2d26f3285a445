"""The port's bench (sylph_tpu_torch/bench.py), fixtures
(sylph_tpu_torch/bench_fixtures.py) and ``multichip.entry`` against the
root bench.py, scripts/gen_*_fixture.py and __graft_entry__.py on the CPU,
at tiny sizes (module constants shrunk with monkeypatch). Nothing here
writes into the repo's .bench_data/: every fixture goes to tmp_path, and
the JAX plant pools that would be cached there are rebuilt from their
parts.
"""

import functools
import importlib.util
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import bench as jbench
import sylph_tpu.tpu.grange as jgr
import sylph_tpu.tpu.synth_index as jsi
from sylph_tpu_torch import bench as tb
from sylph_tpu_torch import bench_fixtures as tf
from sylph_tpu_torch.gpu import grange as tgr
from sylph_tpu_torch.gpu import synth_index as tsi
from sylph_tpu_torch.gpu.keys import HIST_H, from_pair_np
from sylph_tpu_torch.kmer.seeding import fmh_seeds_np

torch.set_num_threads(1)

CPU = "cpu"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(_ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_pair(G=60, KPG=256, seed=3):
    """The same host-built grange index in both packages."""
    kmers, gids = jbench._synth_sorted_index(G * KPG, G, 200, seed=seed)
    kw = dict(chunk_slots=4096, target_mean=16)
    ref = jgr.build_grange_index(kmers, gids, G, presorted=True, **kw)
    port = tgr.build_grange_index(kmers, gids, G, device=CPU, **kw)
    return port, ref


def test_rc31_and_sorted_index_match_jax():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 2 ** 64, size=50_000, dtype=np.uint64)
    v[:3] = [0, 2 ** 62 - 1, 2 ** 64 - 1]
    np.testing.assert_array_equal(tb._rc31_np(v), jbench._rc31_np(v))
    for args in ((5000, 37, 200, 1), (777, 5, 50, 9)):
        got, want = tb._synth_sorted_index(*args), \
            jbench._synth_sorted_index(*args)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gid_max", [None, 7])
def test_usable_plants_and_host_pool_match_jax(gid_max):
    port, ref = _tiny_pair()
    for a, b in zip(tb._usable_plants(port, 4096, gid_max),
                    jbench._usable_plants(ref, 4096, gid_max)):
        np.testing.assert_array_equal(a, b)
    for total in (3000, 20_000):
        got = tb._plant_pool(port, total, n_abundant=7, device=CPU)
        want = jbench._plant_pool(ref, total, n_abundant=7)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def _jax_synth_pool(gidx_chunks, G, KPG, total, n_abundant, mult, dup, kw):
    """JAX's _plant_pool(synth=...) without its disk cache: its
    synth_plants_host calls and its shuffle, as bench.py:252-281 does."""
    ab_k, _ = jsi.synth_plants_host(G, KPG, 200, per_chunk=1 << 22,
                                    gid_max=n_abundant, dup=dup, **kw)
    bg_k, _ = jsi.synth_plants_host(G, KPG, 200, per_chunk=max(
        1024, int((total - ab_k.size * mult) * 1.3 * 8 // gidx_chunks)),
        dup=dup, **kw)
    ab = np.repeat(ab_k, mult)
    rng = np.random.default_rng(11)
    n_bg = max(0, total - ab.size)
    if bg_k.size < n_bg:
        bg = np.tile(bg_k, -(-n_bg // max(1, bg_k.size)))[:n_bg]
    else:
        rng.shuffle(bg_k)
        bg = bg_k[:n_bg]
    if ab.size > total:
        rng.shuffle(ab)
    return np.concatenate([ab, bg])[:total], int(ab_k.size)


@pytest.mark.parametrize("total", [2_000, 40_000])
def test_synth_pool_and_payload_match_jax(monkeypatch, total):
    monkeypatch.setenv("SYLPH_NT", "4")
    G, KPG = 80, 2000
    kw = dict(chunk_slots=1 << 16, target_mean=64)
    gidx = tsi.synth_index_device(G, KPG, 200, device=CPU, **kw)
    orig = tsi.synth_plants_host
    monkeypatch.setattr(tsi, "synth_plants_host",
                        functools.partial(orig, **kw))
    got = tb._plant_pool(gidx, total, n_abundant=9, synth=(G, KPG),
                         device=CPU)
    want = _jax_synth_pool(len(gidx.chunk_keys), G, KPG, total, 9, 3,
                           None, kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    n_b, R = 4, total // 4
    v = tb._plant_payload(got[0][:n_b * R], n_b, R, 1001, CPU)
    phi, plo = jbench._plant_payload(jax, want[0][:n_b * R], n_b, R, 1001)
    np.testing.assert_array_equal(
        v.numpy(), from_pair_np(np.asarray(phi), np.asarray(plo)))


def test_planted_reads_hit_index():
    """Every planted read's sketch holds an index k-mer (the bench's
    matching workload really matches)."""
    port, _ref = _tiny_pair()
    bases8 = torch.randint(0, 4, (2, 64, 256), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    planted, n_ab, n_up = tb._plant_reads(bases8, port, device=CPU)
    assert n_up > 0 and planted.shape == bases8.shape
    assert (planted != bases8).any(dim=2).float().mean() > 0.5
    iset = set()
    for k in port.chunk_keys:
        k = k.numpy().reshape(-1)
        iset.update(k[k != -1].view(np.uint64).tolist())
    for arr in planted.numpy():
        for r in range(arr.shape[0]):
            seeds = np.asarray(fmh_seeds_np(arr[r], c=200, k=31), np.uint64)
            assert any(int(s) in iset for s in seeds), f"read {r} missed"


# ---- the configs, end to end on the CPU ----------------------------------

@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setattr(tb, "BATCH_READS", 256)
    monkeypatch.setattr(tb, "N_BATCHES", 2)
    monkeypatch.setattr(tb, "N_GENOMES", 16)
    monkeypatch.setattr(tb, "KMERS_PER_GENOME", 64)
    monkeypatch.setattr(tb, "N_ABUNDANT", 8)
    monkeypatch.setattr(tb, "DATA", str(tmp_path))
    monkeypatch.setenv("SYLPH_NT", "4")
    return tmp_path


def _json_line(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("argv,metric", [
    (["--config", "profile"], "profile_throughput"),
    (["--config", "sketch"], "sketch_throughput"),
    (["--config", "multisample"], "multisample_containment"),
    (["--genomes", "64"], "gtdb_profile_throughput"),
    (["--genomes", "64", "--dup"], "gtdb_profile_throughput_dupskew"),
    (["--genomes", "64", "--samples", "3"], "gtdb_profile_throughput"),
    (["--genomes", "48", "--index", "host"], "gtdb_profile_throughput"),
])
def test_device_configs_run_on_cpu(tiny, capsys, monkeypatch, argv, metric):
    monkeypatch.setenv("SYLPH_COHORT_SUB", "2")
    # the host-built index at a test's chunk size (its default 2^25-slot
    # chunk is [32768, 1152] buckets whatever the k-mer count)
    monkeypatch.setattr(tgr, "build_grange_index", functools.partial(
        tgr.build_grange_index, chunk_slots=1 << 14))
    assert tb.main([*argv, "--device", "cpu"]) == 0
    out = _json_line(capsys)
    # tiny runs round to a few 1e-4 Gbp/s or below
    assert out["metric"] == metric and out["value"] >= 0
    assert set(out) == {"metric", "value", "unit", "vs_baseline"}


def test_gtdb_result_is_exact(tiny):
    """The gtdb run's histogram equals a searchsorted oracle of its folded
    sample against the index's live keys; --samples rows equal each
    sample's own sweep."""
    gbps, info = tb._bench_gtdb(n_genomes=64, n_samples=3, device=CPU,
                                reps=1, batched_reps=1)
    eng, seed_all = info["engine"], info["seed_all"]
    G = 64
    ge = eng.gidx.g_eff * HIST_H
    rows = torch.cat(info["hists"])
    for s in range(3):
        h, probe, P = eng.hist_device_stream(seed_all(s))
        assert int(probe[0]) == 0 and int(probe[1]) <= P
        assert torch.equal(rows[s], h[:ge])
        sk, sw = tgr.fold_stream(seed_all(s))
        ks, gs = [], []
        for k, g in zip(eng.gidx.chunk_keys, eng.gidx.chunk_gid):
            k, g = k.numpy().reshape(-1), g.numpy().reshape(-1)
            ks.append(k[k != -1].view(np.uint64))
            gs.append(g[k != -1])
        from tests.test_grange import _oracle_hists
        want = _oracle_hists(np.concatenate(ks), np.concatenate(gs), G,
                             sk.numpy().view(np.uint64), sw.numpy())
        np.testing.assert_array_equal(
            h[:G * HIST_H].numpy().reshape(G, HIST_H), want)
        assert want[:, 1:].sum() > 0


def test_file_configs_run_on_cpu(tiny, capsys, monkeypatch):
    root = tiny
    for k, v in dict(E2E_GENOMES=8, E2E_GLEN=20_000, KPG=1024).items():
        monkeypatch.setattr(tf, k, v)
    monkeypatch.setattr(tf, "TOTAL_BP", 150 * 4000)
    tf.gen_e2e(str(root / "e2e"), paired=True, device=CPU)
    monkeypatch.setattr(tf, "TOTAL_BP", 150 * 12_000)
    tf.gen_gtdb_cli(str(root / "gtdb_cli"), G=80, device=CPU)
    asm = root / "asm.fa"
    asm.write_bytes(b">a\n" + b"ACGT" * 5000 + b"\n>b\n" + b"TTGCA" * 3000
                    + b"\n")
    monkeypatch.setattr(tb, "_bench_gtdb_cli", functools.partial(
        tb._bench_gtdb_cli, reps=1, warm=1, cache_dir=str(root / "cache")))
    monkeypatch.setattr(tb, "_bench_sketchdb", functools.partial(
        tb._bench_sketchdb, reps=1, paths=[str(asm)]))
    for config, metric in (
            ("e2e", "e2e_file_to_tsv_throughput"),
            ("e2e_paired", "e2e_paired_file_to_tsv_throughput"),
            ("gtdb_cli", "gtdb_cli_file_to_tsv_throughput"),
            ("sketchdb", "sketch_db_build_throughput")):
        assert tb.main(["--config", config, "--device", "cpu"]) == 0
        out = _json_line(capsys)
        assert out["metric"] == metric and out["value"] >= 0
    assert tb.fasta_bases([str(asm)]) == 20_000 + 15_000
    assert "SYLPH_TPU_CACHE_INDEX" not in os.environ


def test_bench_raises_without_gpu_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tb.main(["--config", "sketch"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tf.main(["gtdb_cli"])
    from sylph_tpu_torch.multichip import entry
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        entry()


# ---- fixtures: the same bytes as the JAX generators -----------------------

def test_e2e_fixture_bytes_match_jax(tmp_path, monkeypatch):
    jgen = _script("gen_e2e_fixture")
    kw = dict(N_GENOMES=8, GLEN=20_000, TOTAL_BP=150 * 3000)
    jout = tmp_path / "jax"
    for k, v in dict(kw, OUT=str(jout)).items():
        monkeypatch.setattr(jgen, k, v)
    (jout).mkdir()
    (jout / "db.syldb").write_bytes(b"")    # the JAX CLI sketch is not run
    monkeypatch.setattr(sys, "argv", ["gen_e2e_fixture.py", "--paired"])
    jgen.main()
    pout = tmp_path / "port"
    for k, v in dict(E2E_GENOMES=8, E2E_GLEN=20_000,
                     TOTAL_BP=150 * 3000).items():
        monkeypatch.setattr(tf, k, v)
    tf.gen_e2e(str(pout), paired=True, device=CPU)
    names = ["reads.fastq.gz", "reads_R1.fastq.gz", "reads_R2.fastq.gz"] \
        + [os.path.join("genomes", f"g{g:04d}.fa") for g in range(8)]
    for n in names:
        assert (pout / n).read_bytes() == (jout / n).read_bytes(), n
    assert (pout / "db.syldb").stat().st_size > 0


def test_gtdb_cli_fixture_bytes_match_jax(tmp_path):
    jgen = _script("gen_gtdb_cli_fixture")
    G, kpg = 70, 512
    jk, jg = jgen.synth_syldb(str(tmp_path / "j.syldb"), G, kpg)
    pk, pg = tf.synth_syldb(str(tmp_path / "p.syldb"), G, kpg, device=CPU)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pg, jg)
    assert (tmp_path / "p.syldb").read_bytes() == \
        (tmp_path / "j.syldb").read_bytes()
    n1 = jgen.synth_planted_fastq(str(tmp_path / "j.fq.gz"), jk, jg, G,
                                  total_bp=150 * 9000)
    n2 = tf.synth_planted_fastq(str(tmp_path / "p.fq.gz"), pk, pg, G,
                                total_bp=150 * 9000)
    assert n1 == n2 == 9000
    assert (tmp_path / "p.fq.gz").read_bytes() == \
        (tmp_path / "j.fq.gz").read_bytes()
    v = np.random.default_rng(2).integers(0, 2 ** 64, 5000, dtype=np.uint64)
    np.testing.assert_array_equal(tf.usable_mask(v), jgen.usable_mask(v))
    ok = v[tf.usable_mask(v)]
    np.testing.assert_array_equal(tf.plant_codes(ok), jgen.plant_codes(ok))


# ---- entry() and the environment switches ---------------------------------

def test_entry_matches_graft_entry():
    import __graft_entry__ as ge
    jfn, jargs = ge.entry()
    jh, jani, jcov = jax.jit(jfn)(*jargs)
    from sylph_tpu_torch.multichip import entry
    fn, args = entry(device=CPU)
    assert all(a.device.type == "cpu" for a in args)
    h, ani, cov = fn(*args)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_allclose(ani.numpy(), np.asarray(jani), rtol=1e-5)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-5)
    assert h[:, 1:].sum() > 0


@pytest.mark.parametrize("env", [{"SYLPH_NT": "1"}, {"SYLPH_NT": "4"},
                                 {"SYLPH_HEAVY_RUN": "4"},
                                 {"SYLPH_HEAVY_RUN": "0", "SYLPH_NT": "4"}])
def test_build_env_switches_match_jax(monkeypatch, env):
    from tests.test_grange import _zipf_world
    from tests.test_torch_grange import _assert_same_index
    kmers, gids, _sk, _sc = _zipf_world(2, n_unique=6_000)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(chunk_slots=1 << 13, target_mean=512)
    ref = jgr.build_grange_index(kmers, gids, 60, **kw)
    port = tgr.build_grange_index(kmers, gids, 60, device=CPU, **kw)
    _assert_same_index(port, ref)
    if "SYLPH_NT" in env:
        assert port.nt == int(env["SYLPH_NT"])
    if "SYLPH_HEAVY_RUN" in env:
        assert (port.n_heavy == 0) == (env["SYLPH_HEAVY_RUN"] == "0")


@pytest.mark.parametrize("hbm_gb", [None, "0.001", "0.05", "1000"])
def test_hbm_gb_residency_matches_jax(monkeypatch, hbm_gb):
    from sylph_tpu.engine.device_exec import DeviceContainment as JDC
    from sylph_tpu_torch.engine.device_exec import DeviceContainment as TDC
    if hbm_gb is not None:
        monkeypatch.setenv("SYLPH_HBM_GB", hbm_gb)
    else:
        monkeypatch.delenv("SYLPH_HBM_GB", raising=False)
    G = 20
    B, CI, n = 4096, 1152, 22
    jidx = types.SimpleNamespace(chunk_hi=[None] * n, B=B, CI=CI)
    tidx = types.SimpleNamespace(chunk_keys=[None] * n, B=B, CI=CI)
    cpu = torch.device("cpu")
    jstub = types.SimpleNamespace(_devices=[jax.devices("cpu")[0]])
    tstub = types.SimpleNamespace(device=cpu, devices=[cpu])
    got = TDC._grange_residency(tstub, tidx)
    if hbm_gb is None:
        assert got is None          # the CPU: every chunk resident
        return
    assert got == JDC._grange_residency(jstub, jidx)
    assert (got is None) == (hbm_gb == "1000")
    del G


def test_layout_cache_path_carries_sylph_nt(monkeypatch, tmp_path):
    from sylph_tpu_torch.core.types import GenomeSketch
    from sylph_tpu_torch.engine.device_exec import _grange_cache_path
    gs = [GenomeSketch(np.arange(5, dtype=np.uint64), None, "g", "c", 200,
                       31, 1000, 30)]
    monkeypatch.delenv("SYLPH_NT", raising=False)
    assert _grange_cache_path(str(tmp_path), 5, gs).endswith("_ntauto")
    monkeypatch.setenv("SYLPH_NT", "4")
    p = _grange_cache_path(str(tmp_path), 5, gs)
    assert os.path.basename(p).startswith("torch_grange_1_5_")
    assert p.endswith("_nt4")


def test_hist_device_stream_honours_cs():
    from tests.test_grange import _world
    kmers, gids, sk, sc = _world(0, m=60_000)
    gidx = tgr.build_grange_index(kmers, gids, 50, device=CPU,
                                  chunk_slots=1 << 14, target_mean=64)
    eng = tgr.GRangeEngine(gidx, device=CPU)
    occ = torch.from_numpy(np.repeat(sk, sc).view(np.int64))
    h0, p0, P0 = eng.hist_device_stream(occ)
    assert int(p0[0]) == 0 and int(p0[1]) <= P0
    # a cell capacity of 1 drops lanes, and the probe shows it
    h1, p1, _P1 = eng.hist_device_stream(occ, cs=1)
    assert int(p1[0]) > 0
    # a generous explicit capacity keeps the histogram exact
    h2, p2, _P2 = eng.hist_device_stream(occ, cs=64)
    assert int(p2[0]) == 0 and torch.equal(h2, h0)
    assert not torch.equal(h1, h0)


@pytest.mark.parametrize("module", ["sylph_tpu_torch.bench",
                                    "sylph_tpu_torch.bench_fixtures"])
def test_entry_points_reexec_with_the_bench_allocator(monkeypatch, module):
    """python -m sylph_tpu_torch.bench (and bench_fixtures) re-exec once
    with bench.py's malloc settings (bench.py:31-36), as themselves."""
    from sylph_tpu_torch import cli
    calls = []
    monkeypatch.setattr(os, "execve",
                        lambda exe, argv, env: calls.append((argv, env)))
    for v in ("MALLOC_MMAP_THRESHOLD_", "SYLPH_NO_MALLOC_TUNE"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(sys, "argv", ["bench", "--config", "sketch"])
    cli._tune_allocator(module)
    (argv, env), = calls
    assert argv == [sys.executable, "-m", module, "--config", "sketch"]
    assert (env["MALLOC_MMAP_THRESHOLD_"], env["MALLOC_TRIM_THRESHOLD_"],
            env["MALLOC_ARENA_MAX"]) == ("17179869184", "-1", "1")
