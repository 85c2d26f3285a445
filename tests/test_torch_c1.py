"""c = 1 in the port's three regimes, on the CPU.

At c = 1 a kept hash can be 2^63 or more, negative as an int64 bit
pattern. The grange engine sorts and slices its keys in uint64 order (on
``keys.u64_order``), as the JAX package sorts its uint64 keys
(sylph_tpu/tpu/grange.py:196-204); an int64 order put such keys first and
``build_grange_index`` raised at its bincount.

- ``profile`` and ``query --device cpu`` of a c = 1 database (two E. coli
  genomes, sketched by the JAX package with ``sketch -c 1``) against the
  o157 reads' c = 1 sketch, in the grange (GRANGE_MIN = 0), bucket
  (BUCKET_MIN and CHUNK patched) and merge regimes: TSVs byte-identical to
  the JAX host engine's.
- The same in the grange regime on the 80-genome world of
  tests/test_torch_cli.py sketched at c = 1 (64 genomes or more, so the
  device prefilter sweeps the chunks), for its .sylsp and for its raw reads
  (streamed to the device view: device sort and offsets).
- With the grange engine's order put back to int64 (``u64_order`` patched
  to the identity in gpu/grange.py) the grange case fails.
- The c = 1 grange layout equals the JAX build field for field.
- ``fold_stream``, ``_sorted_device_sample``, ``batched_slices`` and the
  device offsets put keys of 2^63 and up after the others.
"""

import io
import os

import numpy as np
import pytest
import torch

import sylph_tpu.tpu.grange as jgr
from sylph_tpu.engine.runner import ContainOptions, contain
from sylph_tpu.engine.sketch_cmd import SketchOptions, sketch
from sylph_tpu_torch import cli
from sylph_tpu_torch.engine import runner
from sylph_tpu_torch.engine.device_exec import DeviceContainment
from sylph_tpu_torch.gpu import grange as tgr
from sylph_tpu_torch.gpu.keys import KEY_PAD, u64_order
from sylph_tpu_torch.io import sylformat
from tests.test_torch_cli import world  # noqa: F401
from tests.test_torch_grange import _assert_same_index

torch.set_num_threads(1)
_TF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "test_files")
_TOP = np.uint64(1 << 63)


@pytest.fixture(scope="module")
def c1(tmp_path_factory):
    """(db.syldb, o157_reads.fastq.gz.sylsp) at c = 1, written by the JAX
    package's ``sketch``."""
    d = tmp_path_factory.mktemp("c1")
    sketch(SketchOptions(
        files=[], genomes=[os.path.join(_TF, f"e.coli-{g}.fasta.gz")
                           for g in ("o157", "K12")],
        reads=[os.path.join(_TF, "o157_reads.fastq.gz")],
        db_out_name=str(d / "db"), sample_output_dir=str(d), c=1, k=31,
        threads=3))
    return str(d / "db.syldb"), str(d / "o157_reads.fastq.gz.sylsp")


def _regime(name, monkeypatch):
    if name == "grange":
        monkeypatch.setattr(DeviceContainment, "GRANGE_MIN", 0)
    elif name == "bucket":
        monkeypatch.setattr(DeviceContainment, "BUCKET_MIN", 1000)
        monkeypatch.setattr(DeviceContainment, "CHUNK", 1 << 17)


def _port_tsv(mode, db, smp, tmp_path, monkeypatch):
    """(the port CLI's TSV, its device engine)."""
    engines = []
    make = runner._device_engine_for
    monkeypatch.setattr(runner, "_device_engine_for", lambda *a, **kw:
                        engines.append(make(*a, **kw)) or engines[-1])
    out = tmp_path / f"{mode}.tsv"
    assert cli.main([mode, db, smp, "-c", "1", "--device", "cpu", "-o",
                     str(out)]) == 0
    return out.read_text(), engines[0]


def _jax_tsv(mode, db, smp):
    want = io.StringIO()
    contain(ContainOptions(files=[db, smp], c=1, tpu=False),
            pseudotax=(mode == "profile"), out=want)
    return want.getvalue()


def test_c1_database_holds_keys_past_2_63(c1):
    db, smp = c1
    keys = np.concatenate([g.genome_kmers for g in sylformat.read_syldb(db)])
    sample = sylformat.read_sylsp(smp).kmers
    assert keys.size > 300_000 and (keys >= _TOP).mean() > 0.4
    assert (sample >= _TOP).any() and (sample < _TOP).any()


@pytest.mark.parametrize("mode", ["profile", "query"])
@pytest.mark.parametrize("regime", ["grange", "bucket", "merge"])
def test_c1_tsv_byte_identical_to_jax(c1, regime, mode, tmp_path,
                                      monkeypatch):
    db, smp = c1
    want = _jax_tsv(mode, db, smp)
    _regime(regime, monkeypatch)
    got, eng = _port_tsv(mode, db, smp, tmp_path, monkeypatch)
    assert got == want
    assert len(got.strip().splitlines()) > 1
    assert (eng._grange is not None) == (regime == "grange")
    if regime == "bucket":
        assert eng._use_buckets and len(eng._bchunks) > 1
    if regime == "merge":
        assert eng._grange is None and not eng._use_buckets


@pytest.fixture(scope="module")
def c1_world(world):  # noqa: F811
    """The 80-genome world's genomes and reads sketched at c = 1 by the
    JAX package: (db.syldb, sample.fq.sylsp, sample.fq)."""
    d = world / "c1"
    d.mkdir()
    genomes = sorted(str(p) for p in world.glob("g*.fa.gz"))
    sketch(SketchOptions(files=[], genomes=genomes,
                         reads=[str(world / "sample.fq")],
                         db_out_name=str(d / "db"),
                         sample_output_dir=str(d), c=1, k=31, threads=3))
    return (str(d / "db.syldb"), str(d / "sample.fq.sylsp"),
            str(world / "sample.fq"))


@pytest.mark.parametrize("mode", ["profile", "query"])
@pytest.mark.parametrize("sample", ["sylsp", "reads"])
def test_c1_grange_sweeps_byte_identical_to_jax(c1_world, mode, sample,
                                                tmp_path, monkeypatch):
    db, sylsp, reads = c1_world
    smp = sylsp if sample == "sylsp" else reads
    assert len(sylformat.read_syldb(db)) >= 64
    want = _jax_tsv(mode, db, smp)
    _regime("grange", monkeypatch)
    got, eng = _port_tsv(mode, db, smp, tmp_path, monkeypatch)
    assert got == want
    assert len(got.strip().splitlines()) > 1
    counters = eng._grange.counters
    if sample == "reads":
        assert counters["device_view_sorts"] >= 1
        assert counters["mask_stream_masks"] == 1
    else:
        assert counters["hists_sweeps"] >= 1


def test_c1_grange_in_int64_order_fails(c1, tmp_path, monkeypatch):
    """The grange engine with the fix taken out (keys sorted and searched
    in int64 order) raises at the layout's bincount or gives another TSV:
    the database above pins the fix."""
    db, smp = c1
    want = _jax_tsv("profile", db, smp)
    _regime("grange", monkeypatch)
    monkeypatch.setattr(tgr, "u64_order", lambda k, inplace=False: k)
    try:
        got, _ = _port_tsv("profile", db, smp, tmp_path, monkeypatch)
    except ValueError as e:
        assert "negative" in str(e)
    else:
        assert got != want


@pytest.mark.parametrize("kw", [dict(), dict(chunk_slots=1 << 16,
                                             target_mean=64)])
def test_c1_grange_layout_matches_jax(c1, kw):
    """The default layout (one chunk) and a 5-chunk flat one."""
    genomes = sylformat.read_syldb(c1[0])
    kmers = np.concatenate([g.genome_kmers for g in genomes])
    gids = np.repeat(np.arange(len(genomes), dtype=np.int32),
                     [g.genome_kmers.size for g in genomes])
    ref = jgr.build_grange_index(kmers, gids, len(genomes), **kw)
    port = tgr.build_grange_index(kmers, gids, len(genomes), device="cpu",
                                  **kw)
    _assert_same_index(port, ref)
    assert port.edges_u64[-1, 1] >= _TOP > port.edges_u64[0, 0]


def _mixed_keys(seed, n):
    """n distinct uint64 hashes, about half of them 2^63 or more."""
    rng = np.random.default_rng(seed)
    k = np.unique(rng.integers(0, np.iinfo(np.uint64).max, size=n,
                               dtype=np.uint64, endpoint=False))
    assert (k >= _TOP).any() and (k < _TOP).any()
    return k


def test_u64_order_is_uint64_order():
    k = _mixed_keys(0, 5000)
    t = torch.from_numpy(k.view(np.int64))
    s = u64_order(torch.sort(u64_order(t)).values)
    np.testing.assert_array_equal(s.numpy().view(np.uint64), np.sort(k))
    pad = u64_order(torch.tensor([KEY_PAD]))
    assert bool((pad > u64_order(t)).all())      # the pad sorts last
    x = t.clone()
    assert u64_order(x, inplace=True) is x and torch.equal(u64_order(x), t)


def test_fold_stream_uint64_order():
    k = _mixed_keys(1, 3000)
    rng = np.random.default_rng(2)
    mult = rng.integers(1, 5, size=k.size)
    stream = np.repeat(k.view(np.int64), mult)
    stream = np.concatenate([stream, np.full(77, KEY_PAD, np.int64)])
    skey, w = tgr.fold_stream(torch.from_numpy(rng.permutation(stream)))
    np.testing.assert_array_equal(skey.numpy().view(np.uint64), k)
    np.testing.assert_array_equal(w.numpy(), np.minimum(mult, 63))


def _engine(seed):
    """A 4-chunk grange engine over hashes across the whole uint64 range
    and a sample table half in it."""
    rng = np.random.default_rng(seed)
    kmers = _mixed_keys(seed, 40_000)
    gids = rng.integers(0, 20, size=kmers.size).astype(np.int32)
    idx = tgr.build_grange_index(kmers, gids, 20, chunk_slots=1 << 14,
                                 target_mean=64, device="cpu")
    sk = np.unique(np.concatenate([rng.choice(kmers, 3000, replace=False),
                                   _mixed_keys(seed + 1, 3000)]))
    sc = rng.integers(1, 9, size=sk.size).astype(np.uint32)
    return tgr.GRangeEngine(idx, device="cpu"), sk, sc


def test_sorted_device_sample_and_offsets_uint64_order():
    from tests.test_torch_grange import _stream_view
    eng, sk, sc = _engine(3)
    skey, w = eng._sorted_device_sample(_stream_view(sk, sc, 4))
    np.testing.assert_array_equal(skey.numpy().view(np.uint64), sk)
    np.testing.assert_array_equal(w.numpy(), np.minimum(sc, 63))
    assert eng._device_view_slices(skey) == tgr.slice_sample(eng.gidx, sk)
    assert tgr.slice_sample(eng.gidx, sk)[-1][1] == sk.size


def test_batched_slices_uint64_order():
    eng, sk, sc = _engine(5)
    tables = [(sk, sc), (sk[::3], sc[::3])]
    keys, w, n_live = eng.upload_tables(tables)
    starts, ends = eng.batched_slices(keys, n_live)
    for s, (k, _) in enumerate(tables):
        want = tgr.slice_sample(eng.gidx, k)
        assert [(int(a), int(b)) for a, b in zip(starts[s], ends[s])] == want
    np.testing.assert_array_equal(eng.hists_batched(tables)[0],
                                  eng.hists(sk, sc))
