"""The port on several devices of one process, against the JAX package on
the CPU (its engines on the virtual CPU devices of tests/conftest.py, the
port's on lists of CPU devices, the plain kernel versions):

- the grange engine on three devices (round-robin chunks, a conservation
  fetch and a bincount a device) on the grange dry run's data, made
  smaller with its heavy runs and forced spill, against JAX's engine on
  three devices and the numpy oracle; two process spans' partials sum to
  it; a spanned or multi-device engine refuses the one-device sweeps;
- the sharded merge join on tests/test_device_chunking.py::
  test_sharded_multi_device_counts's data against JAX's sharded engine and
  the port's one-device engine, the batched ``prefetch`` too; two devices
  below GRANGE_MIN never take the bucket regime;
- the CLI on two devices (the o157 fixtures with 64 decoy genomes, merge
  and grange regimes) against the JAX host engine's TSV;
  ``SYLPH_TPU_DEVICES`` trims the device list and asking for more devices
  than exist raises;
- the JAX gates kept on the multi-device and multi-process paths (ROADMAP
  C): no batched grange sweep, no streamed device view and no device mask
  with more than one device or a process span;
- ``make_mesh`` without a group, or with fewer ranks than asked, raises.
"""

import functools
import io
import os

import jax
import numpy as np
import pytest
import torch

import sylph_tpu.api as jsylph
import sylph_tpu.tpu.grange as jgr
from sylph_tpu.core.types import GenomeSketch as JGenome
from sylph_tpu.core.types import SequencesSketch as JSample
from sylph_tpu.engine.device_exec import DeviceContainment as JContainment
from sylph_tpu.engine.runner import ContainOptions, contain
from sylph_tpu_torch import cli, multichip
from sylph_tpu_torch.core.types import GenomeSketch, SequencesSketch
from sylph_tpu_torch.engine import device_exec, runner
from sylph_tpu_torch.engine.device_exec import (DeviceContainment,
                                                resolve_devices)
from sylph_tpu_torch.gpu import grange as tgr

torch.set_num_threads(1)
CPU = torch.device("cpu")
_TF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "test_files")


# ---- the grange engine on three devices -----------------------------------

@pytest.fixture(scope="module")
def grange3():
    """The dry run's world at 2^13-slot chunks: (port index, JAX index,
    kmers, gids, sample kmers, counts), at least three chunks, heavy runs
    and spill."""
    kmers, gids, sk, sc = multichip.grange_world(1 << 13, 4)
    kw = dict(chunk_slots=1 << 13, **multichip.GRANGE_BUILD)
    ref = jgr.build_grange_index(kmers, gids, 40, **kw)
    port = tgr.build_grange_index(kmers, gids, 40, device="cpu", **kw)
    assert len(port.chunk_keys) >= 3
    assert port.n_heavy > 0 and port.spill_kmers.size > 0
    return port, ref, kmers, gids, sk, sc


def test_grange_three_devices_match_jax_and_oracle(grange3):
    port, ref, kmers, gids, sk, sc = grange3
    want = multichip.oracle_hists(kmers, gids, 40, sk, sc)
    jax3 = jgr.GRangeEngine(ref, devices=jax.devices()[:3]).hists(sk, sc)
    eng = tgr.GRangeEngine(port, devices=[CPU] * 3)
    got = eng.hists(sk, sc)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax3)
    np.testing.assert_array_equal(got, want)
    assert got[:, 1:].sum() > 0
    assert eng.counters["hists_sweeps"] == 1


def test_grange_process_spans_sum_to_the_oracle(grange3):
    port, ref, kmers, gids, sk, sc = grange3
    want = multichip.oracle_hists(kmers, gids, 40, sk, sc)
    parts = [tgr.GRangeEngine(port, devices=[CPU] * 2, process_span=(i, 2))
             for i in range(2)]
    assert sorted(parts[0]._dev_chunks) == list(range(
        0, len(port.chunk_keys), 2))
    p0, p1 = (e.partial_hists(sk, sc) for e in parts)
    np.testing.assert_array_equal(p0 + p1, want)
    # spill is counted by process 0 only
    spill = parts[0]._spill_hist(sk, sc)
    assert spill.sum() > 0
    jp1 = jgr.GRangeEngine(ref, devices=jax.devices()[:1],
                           process_span=(1, 2)).hists(sk, sc)
    np.testing.assert_array_equal(p1, jp1)
    # outside a process group the merge is the identity
    np.testing.assert_array_equal(tgr.merge_process_hists(p0), p0)


@pytest.mark.parametrize("devices,span", [(2, None), (1, (0, 2)),
                                          (2, (1, 2))])
def test_grange_one_device_sweeps_refuse_spans_and_devices(grange3, devices,
                                                           span):
    port, _ref, _k, _g, sk, sc = grange3
    eng = tgr.GRangeEngine(port, devices=[CPU] * devices, process_span=span)
    keys = torch.from_numpy(sk.view(np.int64))
    with pytest.raises(RuntimeError, match="one device"):
        eng.hist_device_stream(keys)
    with pytest.raises(RuntimeError, match="one device"):
        eng.hists_batched([(sk, sc), (sk, sc)])
    assert eng.candidate_mask_stream(object(), lambda h: h) is None
    assert eng.counters["batched_sweeps"] == 0


# ---- the sharded merge join -----------------------------------------------

def _chunking_world():
    """tests/test_device_chunking.py::test_sharded_multi_device_counts's
    genomes and sample, in both packages' types."""
    rng = np.random.default_rng(7)
    pool = rng.integers(0, 1 << 48, size=4000, dtype=np.uint64)
    ks = [rng.choice(pool, size=800, replace=False).astype(np.uint64)
          for _ in range(16)]
    skm = rng.choice(pool, size=2000, replace=False).astype(np.uint64)
    scnt = rng.integers(1, 5, size=2000).astype(np.uint32)
    args = [dict(genome_kmers=k, pseudotax_tracked_nonused_kmers=None,
                 file_name=f"g{g}", first_contig_name=f"c{g}", c=100, k=31,
                 gn_size=100000, min_spacing=30) for g, k in enumerate(ks)]
    smp = dict(kmers=skm, counts=scnt, c=100, k=31, file_name="s",
               sample_name=None, paired=False, mean_read_length=150.0)
    return ([JGenome(**a) for a in args], JSample(**smp),
            [GenomeSketch(**a) for a in args], SequencesSketch(**smp), pool)


def _extra_samples(pool, cls):
    out = []
    for seed in range(3):
        r = np.random.default_rng(seed)
        skm = np.unique(r.choice(pool, size=500 + 301 * seed))
        out.append(cls(kmers=skm.astype(np.uint64),
                       counts=r.integers(1, 5, size=skm.size).astype(
                           np.uint32),
                       c=100, k=31, file_name=f"s{seed}", sample_name=None,
                       paired=False, mean_read_length=150.0))
    return out


def test_sharded_merge_join_matches_jax_and_one_device():
    jg, js, tg, ts, pool = _chunking_world()
    jeng = JContainment(jg)
    assert jeng._sharded is not None
    sh = DeviceContainment(tg, devices=[CPU, CPU])
    one = DeviceContainment(tg, device="cpu")
    assert sh._shards is not None and len(sh._shards) == 2
    assert one._shards is None
    c_sh, c_j, c_1 = sh._counts(ts), jeng._counts(js), one._counts(ts)
    assert sh.counters["sharded_joins"] == 1
    n = min(c_sh.size, c_j.size, c_1.size)   # pad tails differ in length
    np.testing.assert_array_equal(c_sh[:n], c_j[:n])
    np.testing.assert_array_equal(c_sh[:n], c_1[:n])
    for c in (c_sh, c_j, c_1):
        assert not c[n:].any()
    for gi in range(len(tg)):
        a, la = sh.genome_covs(gi, ts)
        b, lb = jeng.genome_covs(gi, js)
        assert a.tolist() == b.tolist() and la == lb
    np.testing.assert_array_equal(sh.hists(ts), one.hists(ts))


def test_sharded_prefetch_matches_per_sample_joins():
    _jg, _js, tg, _ts, pool = _chunking_world()
    samples = _extra_samples(pool, SequencesSketch)
    jsamples = _extra_samples(pool, JSample)
    jg = _chunking_world()[0]
    sh = DeviceContainment(tg, devices=[CPU, CPU])
    sh.prefetch(samples)
    assert sh.counters == {"batched_joins": 1, "sharded_joins": 1}
    jeng = JContainment(jg)
    jeng.prefetch(jsamples)
    one = DeviceContainment(tg, device="cpu")
    for s, j in zip(samples, jsamples):
        got = sh._counts(s)          # from the prefetch cache
        want = one._counts(s)
        n = min(got.size, want.size)
        np.testing.assert_array_equal(got[:n], want[:n])
        jc = jeng._counts(j)
        m = min(got.size, jc.size)
        np.testing.assert_array_equal(got[:m], jc[:m])
    assert sh.counters["sharded_joins"] == 1    # no per-sample join


def test_two_devices_never_take_the_bucket_regime(monkeypatch):
    """device_exec.py:172-174: more than one device below GRANGE_MIN
    returns to the sharded join before any bucket code."""
    _jg, _js, tg, ts, _pool = _chunking_world()
    c1 = DeviceContainment(tg, device="cpu")._counts(ts)    # merge
    monkeypatch.setattr(DeviceContainment, "BUCKET_MIN", 1000)
    monkeypatch.setattr(DeviceContainment, "CHUNK", 4096)
    assert DeviceContainment(tg, device="cpu")._use_buckets
    sh = DeviceContainment(tg, devices=[CPU, CPU])
    assert sh._shards is not None and not sh._use_buckets
    assert not sh._bchunks and sh._grange is None
    c2 = sh._counts(ts)
    n = min(c1.size, c2.size)
    np.testing.assert_array_equal(c1[:n], c2[:n])


# ---- the device list --------------------------------------------------------

def test_device_list_and_sylph_tpu_devices(monkeypatch):
    monkeypatch.delenv("SYLPH_TPU_DEVICES", raising=False)
    assert resolve_devices("cpu") == [CPU]
    assert resolve_devices(devices=["cpu"] * 3) == [CPU] * 3
    monkeypatch.setenv("SYLPH_TPU_DEVICES", "2")
    assert resolve_devices(devices=[CPU] * 3) == [CPU] * 2
    with pytest.raises(ValueError, match="more devices"):
        resolve_devices("cpu")
    monkeypatch.setenv("SYLPH_TPU_DEVICES", "1")
    _jg, _js, tg, ts, _pool = _chunking_world()
    eng = DeviceContainment(tg, devices=[CPU, CPU])
    assert eng.devices == [CPU] and eng._shards is None
    monkeypatch.setenv("SYLPH_TPU_DEVICES", "3")
    with pytest.raises(ValueError, match="more devices"):
        DeviceContainment(tg, devices=[CPU, CPU])
    monkeypatch.delenv("SYLPH_TPU_DEVICES")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            resolve_devices("cuda")


def test_residency_cap_counts_distinct_cards(monkeypatch):
    """The resident-chunk cap is one card's chunks times the distinct
    cards: two logical devices on one card share its memory, so they get
    the cap of one card, and two cards twice it."""
    from types import SimpleNamespace
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (0, 10 * gib))
    gidx = SimpleNamespace(chunk_keys=[None] * 100, B=1 << 20, CI=64)
    per_card = int(0.7 * 10 * gib) // ((1 << 20) * 64 * 12)   # 9 chunks

    def cap(*indices):
        devs = [torch.device("cuda", i) for i in indices]
        return DeviceContainment._grange_residency(
            SimpleNamespace(device=devs[0], devices=devs), gidx)
    assert cap(0) == cap(0, 0) == per_card == 9
    assert cap(0, 1) == 2 * per_card
    gidx.chunk_keys = [None] * 9
    assert cap(0, 0) is None


# ---- the CLI on two devices -------------------------------------------------

def make_o157_world(d) -> None:
    """db.syldb and sample.sylsp in directory ``d``, sketched by the JAX
    package as tests/test_multiprocess.py sketches them: the three E. coli
    genomes and o157_reads, plus 64 random 20 kb genomes, so the database
    has the 64 genomes at which the prefilter asks the engine for
    histograms (with three, the device is never swept)."""
    rng = np.random.default_rng(12)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    paths = [os.path.join(_TF, f"e.coli-{n}.fasta.gz")
             for n in ("EC590", "K12", "o157")]
    for g in range(64):
        p = os.path.join(str(d), f"decoy{g:02d}.fa")
        with open(p, "wb") as f:
            f.write(b">decoy%02d\n" % g
                    + acgt[rng.integers(0, 4, size=20_000)].tobytes()
                    + b"\n")
        paths.append(p)
    jsylph.save_db(os.path.join(str(d), "db.syldb"),
                   jsylph.sketch_genomes(paths))
    jsylph.save_sample(os.path.join(str(d), "sample.sylsp"),
                       jsylph.sketch_reads(os.path.join(
                           _TF, "o157_reads.fastq.gz")))


@pytest.fixture(scope="module")
def o157(tmp_path_factory):
    d = tmp_path_factory.mktemp("o157")
    make_o157_world(d)
    return d


def _jax_host_tsv(files, mode="profile"):
    out = io.StringIO()
    contain(ContainOptions(files=files, tpu=False, threads=2),
            pseudotax=(mode == "profile"), out=out)
    return out.getvalue()


def _grange_small(monkeypatch):
    """The grange regime on the o157 database, chunks cut small enough to
    split over devices and processes (tests/multiproc_worker.py:cli_main's
    patches)."""
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 1 << 12)
    monkeypatch.setattr(device_exec, "build_grange_index", functools.partial(
        tgr.build_grange_index, chunk_slots=1 << 13))


def _two_device_tsv(argv, monkeypatch, tmp_path, n_devices=2):
    engines = []

    def make(gsf, gf, gs, device):
        engines.append(DeviceContainment(gs, devices=[CPU] * n_devices))
        return engines[-1]
    monkeypatch.setattr(runner, "_device_engine_for", make)
    out = tmp_path / "out.tsv"
    assert cli.main([*argv, "--device", "cpu", "-t", "2", "-o",
                     str(out)]) == 0
    return out.read_text(), engines[0]


@pytest.mark.parametrize("mode", ["profile", "query"])
def test_cli_two_devices_merge_regime(o157, mode, monkeypatch, tmp_path):
    files = [str(o157 / "db.syldb"), str(o157 / "sample.sylsp")]
    got, eng = _two_device_tsv([mode, *files], monkeypatch, tmp_path)
    assert eng._shards is not None and eng.counters["sharded_joins"] >= 1
    assert got == _jax_host_tsv(files, mode)
    assert len(got.splitlines()) >= 2


def test_cli_two_devices_grange_regime(o157, monkeypatch, tmp_path):
    """Two samples at depth 2 (a cohort the one-device engine would sweep
    in one batch), one of them raw reads (which one device would stream
    into a device view): on two devices both are swept one at a time from
    their host tables."""
    monkeypatch.setenv("SYLPH_COHORT_DEPTH", "2")
    _grange_small(monkeypatch)
    files = [str(o157 / "db.syldb"), str(o157 / "sample.sylsp"),
             os.path.join(_TF, "o157_reads.fastq.gz")]
    got, eng = _two_device_tsv(["profile", *files], monkeypatch, tmp_path)
    g = eng._grange
    assert g is not None and len(g.gidx.chunk_keys) >= 2
    assert g.counters["batched_sweeps"] == 0
    assert g.counters["device_view_sorts"] == 0
    assert g.counters["mask_stream_masks"] == 0
    assert g.counters["hists_sweeps"] == 2
    assert got == _jax_host_tsv(files)


# ---- the JAX gates (ROADMAP C) ---------------------------------------------

@pytest.fixture(scope="module")
def gate_world():
    """80 genomes (>= 64, so the prefilter asks the engine for its device
    mask), no heavy runs and no spill (so one device gives one), and two
    samples drawn from them."""
    rng = np.random.default_rng(5)
    c = 100
    thr = ((1 << 64) - 1) // c
    pool = rng.integers(0, thr, size=60_000, dtype=np.uint64)
    genomes = [GenomeSketch(
        genome_kmers=rng.choice(pool, size=600, replace=False),
        pseudotax_tracked_nonused_kmers=None, file_name=f"g{g}",
        first_contig_name=f"c{g}", c=c, k=31, gn_size=60_000, min_spacing=30)
        for g in range(80)]
    samples = []
    for s in range(2):
        skm = np.unique(np.concatenate(
            [genomes[3 + s].genome_kmers, rng.choice(pool, size=4000)]))
        samples.append(SequencesSketch(
            kmers=skm, counts=rng.integers(1, 6, size=skm.size).astype(
                np.uint32), c=c, k=31, file_name=f"s{s}"))
    return genomes, samples


_MASK_KW = dict(k=31, min_ani=0.95, min_number_kmers=50.0,
                min_count_correct=3.0, no_adj=False)


def _grange_engine(genomes, monkeypatch, n_devices, span=None):
    monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    monkeypatch.setattr(device_exec, "build_grange_index", functools.partial(
        tgr.build_grange_index, chunk_slots=1 << 13, target_mean=256))
    if span is not None:
        monkeypatch.setattr(device_exec, "process_count", lambda: span[1])
        monkeypatch.setattr(device_exec, "process_index", lambda: span[0])
    return DeviceContainment(genomes, devices=[CPU] * n_devices)


def test_one_device_engine_takes_the_device_paths(gate_world, monkeypatch):
    """The control: one device, one process takes the stream view, the
    device mask and the batched sweep."""
    genomes, samples = gate_world
    eng = _grange_engine(genomes, monkeypatch, 1)
    assert eng.serves_streams() and eng.sample_streamer() is not None
    assert eng.candidates_mask(samples[0], _MASK_KW) is not None
    eng.prefetch(samples)
    assert eng._grange.counters["batched_sweeps"] == 1


@pytest.mark.parametrize("n_devices,span", [(2, None), (1, (0, 2)),
                                            (3, (1, 2))])
def test_gates_no_batched_sweep_stream_view_or_device_mask(
        gate_world, monkeypatch, n_devices, span):
    genomes, samples = gate_world
    eng = _grange_engine(genomes, monkeypatch, n_devices, span)
    assert eng._grange_span == span
    assert eng.serves_histograms()
    assert not eng.serves_streams() and eng.sample_streamer() is None
    assert runner.cohort_depth(eng) == 8
    assert eng.candidates_mask(samples[0], _MASK_KW) is None
    eng.prefetch(samples)
    c = eng._grange.counters
    assert c["batched_sweeps"] == 0 and c["mask_stream_masks"] == 0
    assert c["device_view_sorts"] == 0
    # the histogram is the one-device engine's (a span's: its partial)
    monkeypatch.undo()
    full = _grange_engine(genomes, monkeypatch, 1).hists(samples[1])
    if span is None:
        np.testing.assert_array_equal(eng.hists(samples[1]), full)
    else:
        other = _grange_engine(genomes, monkeypatch, 1,
                               (1 - span[0], 2)).hists(samples[1])
        np.testing.assert_array_equal(eng.hists(samples[1]) + other, full)


# ---- make_mesh -------------------------------------------------------------

def test_make_mesh_raises_without_a_group_or_enough_ranks():
    import torch.distributed as dist

    from sylph_tpu_torch.gpu.pipeline import make_mesh
    from sylph_tpu_torch.utils import distributed as ud
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2, device="cpu")
    ud.init_group(f"127.0.0.1:{multichip.free_port()}", 1, 0)
    try:
        with pytest.raises(ValueError, match="need 2 ranks"):
            make_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="cannot factor"):
            make_mesh(1, dp=2, device="cpu")
        mesh = make_mesh(device="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("dp", "ip")
    finally:
        ud.shutdown()
    assert not dist.is_initialized()
