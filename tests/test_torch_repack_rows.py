"""The row repacks B11 and B12 against the Pallas kernels on the CPU.

- ``repack_rows_plain`` (B11) and ``repack1_rows_plain`` (B12) of
  sylph_tpu_torch/gpu/seeding.py against ``repack_pallas`` and
  ``repack1_pallas`` (sylph_tpu/tpu/pallas_seeding.py) in interpret mode,
  bit for bit (pairs as int64 keys through gpu/keys.py::from_pair_np): 256-
  and 128-multiple geometries, row counts that are and are not a multiple
  of the Pallas row block, fewer rows than a block, B12's narrow blocks of
  wide rows, an overflow whose loss shows, and the geometry errors.
- The pad rule of B8 and B11: the JAX kernels drop every entry whose high
  word is 0xFFFFFFFF; the port drops only the key -1 (ROADMAP C).

Streams are made by numpy from a seed; dead slots hold (SENT, SENT), as
every stream at c >= 2 does. n stays small: interpret mode routes a
butterfly for each row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.tpu.bucket_fill import repack2_flat as j_repack2
from sylph_tpu.tpu.pallas_seeding import repack1_pallas, repack_pallas
from sylph_tpu_torch.gpu import bucket_fill as tbf
from sylph_tpu_torch.gpu import seeding as tsd
from sylph_tpu_torch.gpu.keys import from_pair_np

torch.set_num_threads(1)
SENT = np.uint32(0xFFFFFFFF)


def _pairs(seed, n, dens):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**31, size=n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    dead = rng.random(n) > dens
    hi[dead] = SENT
    lo[dead] = SENT
    return hi, lo, int((~dead).sum())


def _codes(seed, n, dens):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 2**31, size=n, dtype=np.uint32)
    dead = rng.random(n) > dens
    v[dead] = SENT
    return v, int((~dead).sum())


# (seed, n, row, cap, dens, rows_pad): the padded row count is the output's
_B11 = [
    (0, 20_000, 1024, 256, 0.15, 20),        # 256-multiple, 20 rows: tr = 20
    (1, 30_000, 384, 128, 0.2, 79),          # 128-only geometries
    (2, 50_000, 640, 256, 0.2, 79),
    (3, 300 * 128 - 50, 128, 128, 0.3, 512),  # 300 rows -> 2 blocks of 256
    (4, 40_000, 512, 128, 0.35, 79),         # overflows its rows
]


@pytest.mark.parametrize("seed,n,row,cap,dens,rows_pad", _B11)
def test_repack_rows_plain_matches_pallas(seed, n, row, cap, dens, rows_pad):
    hi, lo, n_live = _pairs(seed, n, dens)
    gh, gl = repack_pallas(jnp.asarray(hi), jnp.asarray(lo), row=row,
                           cap=cap, interpret=True)
    want = from_pair_np(np.asarray(gh), np.asarray(gl))
    got = tsd.repack_rows(torch.from_numpy(from_pair_np(hi, lo)), row=row,
                          cap=cap).numpy()
    assert got.shape == want.shape == (rows_pad, cap)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tsd.repack_rows_plain(
        torch.from_numpy(from_pair_np(hi, lo)), row=row, cap=cap).numpy())
    lost = n_live - int((got != -1).sum())
    assert (lost > 0) == (seed == 4)


_B12 = [
    (0, 5000, 512, 128, 0.1, 10),            # 256-multiple, 10 rows
    (1, 30_000, 384, 128, 0.2, 79),          # 128-only geometries
    (2, 50_000, 640, 256, 0.2, 79),
    (3, 300 * 128 - 7, 128, 128, 0.3, 512),  # 300 rows -> 2 blocks of 256
    (4, 17 * 32768 + 100, 32768, 1024, 0.02, 32),   # tr = 16: 18 -> 32
    (5, 40_000, 512, 128, 0.35, 79),         # overflows its rows
]


@pytest.mark.parametrize("seed,n,row,cap,dens,rows_pad", _B12)
def test_repack1_rows_plain_matches_pallas(seed, n, row, cap, dens,
                                           rows_pad):
    v, n_live = _codes(seed, n, dens)
    want = np.asarray(repack1_pallas(jnp.asarray(v), row=row, cap=cap,
                                     interpret=True)).view(np.int32)
    vt = torch.from_numpy(v.view(np.int32))
    got = tsd.repack1_rows(vt, row=row, cap=cap).numpy()
    assert got.shape == want.shape == (rows_pad, cap)
    np.testing.assert_array_equal(got, want)
    lost = n_live - int((got != -1).sum())
    assert (lost > 0) == (seed == 5)


def test_b12_row_block_rule():
    """B12's block: min(256, max(8, 2^19 // row)), cut to the row count."""
    assert tsd._b12_block(32768) == 16
    assert tsd._b12_block(65536) == 8 and tsd._b12_block(1 << 20) == 8
    assert tsd._b12_block(1024) == 256
    assert tsd._rows_padded(18 * 65536, 65536, 8) == 24
    assert tsd._rows_padded(5 * 65536, 65536, 8) == 5


@pytest.mark.parametrize("row,cap", [(200, 128), (256, 100), (256, 384),
                                     (384, 64)])
def test_row_repacks_reject_what_pallas_rejects(row, cap):
    hi, lo, _ = _pairs(0, 4096, 0.2)
    v, _ = _codes(0, 4096, 0.2)
    with pytest.raises(ValueError):
        repack_pallas(jnp.asarray(hi), jnp.asarray(lo), row=row, cap=cap,
                      interpret=True)
    with pytest.raises(ValueError):
        repack1_pallas(jnp.asarray(v), row=row, cap=cap, interpret=True)
    keys = torch.from_numpy(from_pair_np(hi, lo))
    codes = torch.from_numpy(v.view(np.int32))
    for fn, x in ((tsd.repack_rows, keys), (tsd.repack_rows_plain, keys),
                  (tsd.repack1_rows, codes), (tsd.repack1_rows_plain, codes)):
        with pytest.raises(ValueError):
            fn(x, row=row, cap=cap)


def test_row_repacks_accept_what_the_flat_repack_rejects():
    """128-multiples pass B11/B12's check and fail B3/B8's (256)."""
    keys = torch.from_numpy(from_pair_np(*_pairs(0, 4096, 0.2)[:2]))
    assert tsd.repack_rows(keys, row=384, cap=128).shape == (11, 128)
    with pytest.raises(ValueError):
        tbf.repack2_flat(keys, row=384, cap=128)


def _oracle(keys, nwin, row, cap, live):
    """Per window, the entries where ``live`` holds, in order, cut at
    cap, -1 after."""
    out = np.full((nwin, cap), -1, np.int64)
    k = np.full(nwin * row, -1, np.int64)
    m = np.zeros(nwin * row, bool)
    k[:keys.size], m[:keys.size] = keys, live
    for w in range(nwin):
        sel = k[w * row:(w + 1) * row][m[w * row:(w + 1) * row]][:cap]
        out[w, :sel.size] = sel
    return out


def test_pad_rule_high_word_sent_is_live_in_the_port():
    """Entries whose high word is 0xFFFFFFFF and whose low word is not:
    the JAX B8 (repack2_flat) and B11 (repack_pallas) drop them
    (bucket_fill.py:188, pallas_seeding.py:320); the port's B8 and B11
    keep them in order, as they keep every key but -1 (csrc/repack.cu:46).
    At c = 1 such a key is a real hash."""
    rng = np.random.default_rng(7)
    n, row, cap = 8192, 1024, 512
    hi, lo, _ = _pairs(7, n, 0.2)
    odd = rng.choice(np.flatnonzero(hi == SENT), size=40, replace=False)
    lo[odd] = rng.integers(0, 2**32 - 1, size=40, dtype=np.uint32)
    keys = from_pair_np(hi, lo)
    port_live, jax_live = keys != -1, hi != SENT
    assert (port_live & ~jax_live).sum() == 40

    jh, jl = j_repack2(jnp.asarray(hi), jnp.asarray(lo), row=row, cap=cap,
                       interpret=True)
    got8 = tbf.repack2_flat(torch.from_numpy(keys), row=row, cap=cap)
    nwin8 = 8 * (-(-n // (8 * row)))
    np.testing.assert_array_equal(
        from_pair_np(np.asarray(jh), np.asarray(jl)).reshape(nwin8, cap),
        _oracle(keys, nwin8, row, cap, jax_live))
    np.testing.assert_array_equal(got8.numpy().reshape(nwin8, cap),
                                  _oracle(keys, nwin8, row, cap, port_live))

    rh, rl = repack_pallas(jnp.asarray(hi), jnp.asarray(lo), row=row,
                           cap=cap, interpret=True)
    got11 = tsd.repack_rows(torch.from_numpy(keys), row=row, cap=cap)
    rows = n // row
    np.testing.assert_array_equal(
        from_pair_np(np.asarray(rh), np.asarray(rl)),
        _oracle(keys, rows, row, cap, jax_live))
    np.testing.assert_array_equal(got11.numpy(),
                                  _oracle(keys, rows, row, cap, port_live))
    # the kept odd keys are the whole difference
    for got in (got8.numpy(), got11.numpy()):
        kept = got[got != -1]
        assert np.isin(keys[odd], kept).all()
        assert kept.size == int(port_live.sum())
