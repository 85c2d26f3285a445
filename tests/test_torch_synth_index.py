"""The port's synthetic benchmark index (sylph_tpu_torch/gpu/synth_index.py)
against the JAX package's (sylph_tpu/tpu/synth_index.py) on the CPU, at
JAX's own test shapes (tests/test_synth_index.py): the index field by field,
the host replays, the plants and the marker expansion exactly, and the
port's grange engine on the synthetic index against a brute-force oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sylph_tpu.tpu.synth_index as jsi
from sylph_tpu_torch.gpu import synth_index as tsi
from sylph_tpu_torch.gpu.grange import GRangeEngine
from sylph_tpu_torch.gpu.keys import HIST_H, from_pair_np
from tests.test_grange import _oracle_hists

torch.set_num_threads(1)

CPU = "cpu"
G, KPG, C = 97, 3000, 50
FLAT = dict(chunk_slots=1 << 16, target_mean=64)
G2, KPG2 = 60, 2000
DUP = dict(chunk_slots=1 << 15, target_mean=256)


def _spec():
    return dict(hf=0.5, r=4, lbase=20, lmod=16)


def _jax_index(G_, KPG_, nt, kw, dup=None, csr_host=False):
    return jsi.synth_index_device(G_, KPG_, C, devices=[jax.devices("cpu")[0]],
                                  nt=nt, dup=dup, csr_host=csr_host, **kw)


_CASES = {
    "flat": (G, KPG, 1, FLAT, False, False),
    "tiled": (G, KPG, 4, FLAT, False, False),
    "dup_csr_host": (G2, KPG2, 4, DUP, True, True),
    "dup_virtual": (G2, KPG2, 4, DUP, True, False),
}


@pytest.fixture(scope="module")
def pairs():
    """case -> (port index, JAX index, port DupSpec, JAX DupSpec)."""
    out = {}
    for name, (g, kpg, nt, kw, dup, csr) in _CASES.items():
        jd = jsi.DupSpec(**_spec()) if dup else None
        td = tsi.DupSpec(**_spec()) if dup else None
        ref = _jax_index(g, kpg, nt, kw, jd, csr)
        port = tsi.synth_index_device(g, kpg, C, device=CPU, nt=nt, dup=td,
                                      csr_host=csr, **kw)
        out[name] = (port, ref, td, jd)
    return out


@pytest.mark.parametrize("case", sorted(_CASES))
def test_index_matches_jax_field_by_field(pairs, case):
    port, ref, td, jd = pairs[case]
    assert len(port.chunk_keys) == len(ref.chunk_hi) >= 2
    for k, g, rh, rl, rg in zip(port.chunk_keys, port.chunk_gid,
                                ref.chunk_hi, ref.chunk_lo, ref.chunk_gid):
        assert k.dtype == torch.int64 and g.dtype == torch.int32
        np.testing.assert_array_equal(
            k.numpy(), from_pair_np(np.asarray(rh), np.asarray(rl)))
        np.testing.assert_array_equal(g.numpy(), np.asarray(rg))
    for f in ("bases", "edges_u64", "heavy_ptr", "heavy_gids",
              "spill_kmers", "spill_gids"):
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("width", "B", "CI", "m", "nt", "ov", "n_genomes", "n_heavy",
              "g_eff", "tile", "subwidth"):
        assert getattr(port, f) == getattr(ref, f), f
    if td is not None:
        assert td.q == jd.q and td.q is not None


@pytest.mark.parametrize("case", ["flat", "tiled", "dup_csr_host"])
def test_host_replay_matches_jax(pairs, case):
    port, _ref, td, jd = pairs[case]
    g, kpg, nt, kw, _dup, _csr = _CASES[case]
    got = tsi.synth_chunks_host(g, kpg, C, nt=nt, dup=td, **kw)
    want = jsi.synth_chunks_host(g, kpg, C, nt=nt, dup=jd, **kw)
    assert len(got) == len(want) == len(port.chunk_keys)
    for (k, gid), (hh, hl, hg), dk in zip(got, want, port.chunk_keys):
        np.testing.assert_array_equal(k, from_pair_np(hh, hl))
        np.testing.assert_array_equal(gid, hg)
        np.testing.assert_array_equal(k, dk.numpy())
    last = len(got) - 1
    one = tsi.synth_chunks_host(g, kpg, C, nt=nt, dup=td, chunks=[last],
                                **kw)
    np.testing.assert_array_equal(one[0][0], got[last][0])
    np.testing.assert_array_equal(one[0][1], got[last][1])


@pytest.mark.parametrize("case,gid_max", [
    ("flat", None), ("flat", 13), ("tiled", None), ("tiled", 13),
    ("dup_csr_host", None), ("dup_csr_host", 11)])
def test_plants_match_jax(pairs, case, gid_max):
    _port, _ref, td, jd = pairs[case]
    g, kpg, nt, kw, _dup, _csr = _CASES[case]
    got = tsi.synth_plants_host(g, kpg, C, per_chunk=256, gid_max=gid_max,
                                nt=nt, dup=td, device=CPU, **kw)
    want = jsi.synth_plants_host(g, kpg, C, per_chunk=256, gid_max=gid_max,
                                 nt=nt, dup=jd, **kw)
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int32
    assert got[0].size > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_inverse_hash_and_rc_match_numpy():
    from bench import _rc31_np
    from sylph_tpu_torch.gpu.seeding import mm_hash64
    from sylph_tpu_torch.kmer.hashing import inv_mm_hash64_np
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2 ** 64, size=20_000, dtype=np.uint64)
    x[:4] = [0, 1, 2 ** 63, 2 ** 64 - 1]
    t = torch.from_numpy(x.view(np.int64))
    np.testing.assert_array_equal(
        tsi.inv_mm_hash64(t).numpy().view(np.uint64), inv_mm_hash64_np(x))
    assert torch.equal(mm_hash64(tsi.inv_mm_hash64(t)), t)
    np.testing.assert_array_equal(tsi.rc31(t).numpy().view(np.uint64),
                                  _rc31_np(x))


def _logical_table(port, spec, G_):
    """Every (kmer, gid) of the dup index: grid slots and markers expanded
    through the CSR replay."""
    ks, gs = [], []
    for k, g in zip(port.chunk_keys, port.chunk_gid):
        k, g = k.numpy().reshape(-1), g.numpy().reshape(-1)
        live = k != -1
        v, g = k[live].view(np.uint64), g[live]
        mk = g >= G_
        ks.append(v[~mk])
        gs.append(g[~mk])
        rr = (g[mk] - G_).astype(np.int64)
        lens = tsi.heavy_lengths_np(port.n_heavy, spec.lbase,
                                    spec.lmod)[rr]
        i = (np.arange(int(lens.sum()), dtype=np.int64)
             - np.repeat(np.concatenate([[0], np.cumsum(lens)[:-1]]), lens))
        ks.append(np.repeat(v[mk], lens))
        gs.append(tsi.heavy_gids_np(np.repeat(rr, lens), i, G_))
    return np.concatenate(ks), np.concatenate(gs).astype(np.int32)


@pytest.fixture(scope="module")
def dup_hist(pairs):
    """The dup index's device-stream histogram of a sample, from both
    engines, and the sample's oracle."""
    port, ref, td, _jd = pairs["dup_csr_host"]
    kmers, gids = _logical_table(port, td, G2)
    assert port.m == kmers.size
    rng = np.random.default_rng(5)
    uniq = np.unique(kmers)
    hit = rng.choice(uniq, size=min(3000, uniq.size), replace=False)
    noise = rng.integers(0, ((1 << 64) - 1) // C, size=2000, dtype=np.uint64)
    sk = np.unique(np.concatenate([hit, noise]))
    sc = rng.integers(1, 6, size=sk.size).astype(np.uint32)
    want = _oracle_hists(kmers, gids, G2, sk, sc)
    occ = np.repeat(sk, sc)
    T = 1 << int(np.ceil(np.log2(occ.size)))
    shi = np.full(T, 0xFFFFFFFF, np.uint32)
    slo = np.full(T, 0xFFFFFFFF, np.uint32)
    shi[:occ.size] = (occ >> np.uint64(32)).astype(np.uint32)
    slo[:occ.size] = occ.astype(np.uint32)
    from sylph_tpu.tpu.grange import GRangeEngine as JEngine
    jh, check = JEngine(ref, devices=[jax.devices("cpu")[0]]) \
        .hist_device_stream(jnp.asarray(shi), jnp.asarray(slo),
                            n_live=occ.size, n_unique=sk.size)
    assert check()
    eng = GRangeEngine(port, device=CPU)
    th, probe, P = eng.hist_device_stream(
        torch.from_numpy(occ.view(np.int64)))
    assert int(probe[0]) == 0 and int(probe[1]) <= P
    return eng, sk, sc, want, np.asarray(jh), th


def test_dup_engine_stream_matches_oracle_and_jax(dup_hist):
    eng, sk, sc, want, jh, th = dup_hist
    n = (G2 + eng.gidx.n_heavy) * HIST_H
    np.testing.assert_array_equal(th.numpy()[:n], jh[:n])
    np.testing.assert_array_equal(eng.hists(sk, sc), want)
    assert want.sum() > 0


@pytest.mark.parametrize("caps", ["exact", "few_runs", "few_entries"])
def test_expand_markers_matches_jax(pairs, dup_hist, caps):
    port, _ref, td, _jd = pairs["dup_csr_host"]
    eng, _sk, _sc, want, jh, th = dup_hist
    kw = dict(G=G2, n_heavy=port.n_heavy, lbase=td.lbase, lmod=td.lmod)
    jr, je = jsi.measure_marker_hits(jnp.asarray(jh), **kw)
    tr, te = tsi.measure_marker_hits(th, **kw)
    assert int(tr) == int(jr) > 0 and int(te) == int(je)
    n_rows, n_ent = int(tr), int(te)
    runs_cap, entries_cap = {
        "exact": (n_rows + 8, n_ent + 64),
        "few_runs": (max(1, n_rows // 2), n_ent + 64),
        "few_entries": (n_rows + 8, max(1, n_ent // 3))}[caps]
    jx, jok = jsi.expand_markers_device(jnp.asarray(jh), runs_cap=runs_cap,
                                        entries_cap=entries_cap, **kw)
    tx, tok = tsi.expand_markers_device(th, runs_cap=runs_cap,
                                        entries_cap=entries_cap, **kw)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert bool(tok) == bool(jok) == (caps == "exact")
    if caps == "exact":
        np.testing.assert_array_equal(tx.numpy().reshape(G2, HIST_H), want)
    # the batched form: two rows, each its own expansion
    hs = torch.stack([th[:-1], th[:-1]])
    jb, jbok = jsi.expand_markers_device_batched(
        jnp.asarray(np.stack([jh[:-1], jh[:-1]])), runs_cap=runs_cap,
        entries_cap=entries_cap, **kw)
    tb, tbok = tsi.expand_markers_device_batched(
        hs, runs_cap=runs_cap, entries_cap=entries_cap, **kw)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert bool(tbok) == bool(jbok)


@pytest.mark.parametrize("case", ["flat", "tiled"])
def test_engine_on_synth_index_matches_brute_force(pairs, case):
    port, _ref, _td, _jd = pairs[case]
    ks, gs = [], []
    for k, g in zip(port.chunk_keys, port.chunk_gid):
        k, g = k.numpy().reshape(-1), g.numpy().reshape(-1)
        ks.append(k[k != -1].view(np.uint64))
        gs.append(g[k != -1])
    kmers, gids = np.concatenate(ks), np.concatenate(gs)
    rng = np.random.default_rng(1)
    plants = kmers[::max(1, kmers.size // 4096)][:4096]
    noise = rng.integers(0, ((1 << 64) - 1) // C, size=4096,
                         dtype=np.uint64)
    occ = np.concatenate([plants, noise, plants[:777]])
    sk, sc = np.unique(occ, return_counts=True)
    want = _oracle_hists(kmers, gids, G, sk, sc.astype(np.uint32))
    eng = GRangeEngine(port, device=CPU)
    hist, probe, P = eng.hist_device_stream(
        torch.from_numpy(rng.permutation(occ).view(np.int64)))
    assert int(probe[0]) == 0 and int(probe[1]) <= P
    np.testing.assert_array_equal(
        hist.numpy()[:G * HIST_H].reshape(G, HIST_H), want)
    assert want[:, 1:].sum() >= plants.size


def test_counters_past_2_32_raise():
    # 10^6 genomes x 7,168 k-mers: 214 chunks, counters up to ~8.1e9
    with pytest.raises(ValueError, match="2\\^32"):
        tsi.synth_index_device(1_000_000, 7168, 200, device=CPU, nt=4)
    with pytest.raises(ValueError, match="2\\^32"):
        tsi.synth_chunks_host(1_000_000, 7168, 200, nt=1, chunks=[0])
    with pytest.raises(ValueError, match="2\\^32"):
        tsi.synth_plants_host(1_000_000, 7168, 200, nt=4, device=CPU)


def test_heavy_expand_on_a_virtual_csr_raises(pairs):
    port, _ref, td, _jd = pairs["dup_virtual"]
    assert port.heavy_gids.size == 0 and port.heavy_ptr[-1] > 0
    eng = GRangeEngine(port, device=CPU)
    hh = np.zeros((port.n_heavy, HIST_H), np.int64)
    hh[0, 1] = 1
    with pytest.raises(ValueError, match="virtual CSR"):
        eng.heavy_expand(hh)
    # the materialized CSR of the same geometry expands
    full, *_ = pairs["dup_csr_host"]
    out = GRangeEngine(full, device=CPU).heavy_expand(hh)
    assert out.sum() == full.heavy_ptr[1] - full.heavy_ptr[0]
