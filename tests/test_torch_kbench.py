"""The plain versions of sylph_tpu_torch/kbench.py against numpy
restatements of scripts/kbench.py's bodies, on the CPU.

- alu_chain (kbench.py:69-75): y = x; y += x >> (1 + i % 7), on uint32.
- roll_chain(n, 256) and roll_chain(n, 128) (kbench.py:55-66): np.roll by
  1 + i % 7 along the lanes, of the whole row or of each half (n // 2
  steps); sublane_roll_chain (kbench.py:78-83): np.roll along the rows of
  each 256-row tile (the Pallas block); the warp roll is np.roll within
  32-lane groups.
- B6's primitives: the funnel-shift chain on uint32 and the rank chain
  (a cumulative count of the predicate bits).
- The wrappers on a CPU tensor run these plain versions, check their
  inputs, and the library calls equal the chains.

scripts/kbench.py is not imported: it points JAX's persistent cache into
the repository when it is.
"""

import numpy as np
import pytest
import torch

from sylph_tpu_torch import kbench

torch.set_num_threads(1)
R = 512                      # two sublane tiles of 256 rows, 256 lanes


def _x(seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, size=(R, kbench.L), dtype=np.uint32)
    return u, torch.from_numpy(u.view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", kbench.STEPS)
def test_alu_chain_matches_numpy(n):
    u, x = _x(n)
    y = u.copy()
    for i in range(n):
        y = y + (u >> np.uint32(1 + i % 7))
    np.testing.assert_array_equal(_u(kbench.alu_chain_plain(x, n)), y)


@pytest.mark.parametrize("n", kbench.STEPS)
def test_lane_rolls_match_numpy(n):
    u, x = _x(n + 1)
    full = u.copy()
    for i in range(n):
        full = np.roll(full, 1 + i % 7, axis=1)
    np.testing.assert_array_equal(_u(kbench.lane_roll_plain(x, n)), full)
    xl, xr = u[:, :128], u[:, 128:]
    for i in range(n // 2):
        xl = np.roll(xl, 1 + i % 7, axis=1)
        xr = np.roll(xr, 1 + i % 7, axis=1)
    np.testing.assert_array_equal(_u(kbench.half_roll_plain(x, n)),
                                  np.concatenate([xl, xr], axis=1))
    w = u.reshape(R, 8, 32)
    for i in range(n):
        w = np.roll(w, 1 + i % 7, axis=2)
    np.testing.assert_array_equal(_u(kbench.warp_roll_plain(x, n)),
                                  w.reshape(R, 256))


@pytest.mark.parametrize("n", kbench.STEPS)
def test_sublane_roll_matches_numpy(n):
    u, x = _x(n + 2)
    tiles = [u[t:t + 256] for t in range(0, R, 256)]
    for i in range(n):
        tiles = [np.roll(t, 1 + i % 7, axis=0) for t in tiles]
    np.testing.assert_array_equal(_u(kbench.sublane_roll_plain(x, n)),
                                  np.concatenate(tiles))


@pytest.mark.parametrize("n", kbench.STEPS)
def test_b6_primitives_match_numpy(n):
    u, x = _x(n + 3)
    a = u.copy()
    for i in range(n):
        s = np.uint32(1 + i % 7)
        a = (a >> s) | (u << np.uint32(32 - s))
    np.testing.assert_array_equal(_u(kbench.funnel_chain_plain(x, n)), a)
    acc = np.zeros(u.shape, np.int64)
    for i in range(n):
        p = ((u >> np.uint32(i % 31)) & 1).astype(np.int64)
        acc += np.cumsum(p, axis=1) - p
    np.testing.assert_array_equal(kbench.rank_chain_plain(x, n).numpy(), acc)


@pytest.mark.parametrize("kind,n", list(kbench._lines()))
def test_cpu_launch_runs_the_plain_version(kind, n):
    _, x = _x(7)
    got = kbench.launch(kind, x, n)
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert torch.equal(got, kbench.PLAIN[kind](x, n))
    lib = kbench.library_call(kind, x, n)
    if lib is not None:
        assert torch.equal(lib.reshape(x.shape), got)


def test_launch_rejects_bad_inputs():
    _, x = _x()
    with pytest.raises(ValueError):
        kbench.launch("alu", x[:100], 16)
    with pytest.raises(ValueError):
        kbench.launch("alu", x, 32)
    with pytest.raises(ValueError):
        kbench.launch("identity", x, 16)
    with pytest.raises(ValueError):
        kbench.launch("shuffle", x, 16)


def test_kbench_needs_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kbench.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError):
        kbench.table("cpu")
