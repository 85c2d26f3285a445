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
- chip_smoke.py's operations bound: the least SM clocks of a mix of
  instructions by pipe, and the window count it gives B6 at (q)'s shape.

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


def test_kernel_ab_needs_the_card(monkeypatch, capsys, tmp_path):
    """The A/B of kernels against another tree's builds nothing and exits
    2 without a card."""
    from sylph_tpu_torch import kernel_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main([str(tmp_path)]) == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["B7 reads", "B1 grange", "B3 grange",
                                  "B8 reads", "kbench identity", "B6 reads",
                                  "B6 gtdb", "B9 reads"])
def test_kernel_ab_loads_a_tree_apart(case):
    """kernel_ab imports another tree (here this one) as a package of its
    own, with its own kernel build and launch counts, and that tree's
    wrapper of each kind of case, given the case's inputs at a small size,
    gives what this tree's gives (both run the plain version on the
    CPU)."""
    import importlib
    import os
    import sys

    from sylph_tpu_torch import kernel_ab
    from sylph_tpu_torch.gpu import _cuda
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    kernel_ab._load_tree(root)
    try:
        module, wrapper, _, _, _ = kernel_ab.CASES[case]
        old = importlib.import_module(f"{kernel_ab._OLD}.{module}")
        new = importlib.import_module(f"sylph_tpu_torch.{module}")
        assert old is not new
        old_cuda = importlib.import_module(f"{kernel_ab._OLD}.gpu._cuda")
        assert old_cuda.LAUNCHES is not _cuda.LAUNCHES
        rng = np.random.default_rng(3)
        args = {"B7 reads": lambda: kernel_ab._reads(rng, 8, 256, 150),
                "B1 grange": lambda: kernel_ab._slice(rng, 64, 4, 3, 500,
                                                      600),
                "B3 grange": lambda: kernel_ab._pad_stream(
                    rng, 70_000, np.int32, 0.01, 4096, 256),
                "B8 reads": lambda: kernel_ab._pad_stream(
                    rng, 70_000, np.int64, 0.1, 16384, 2048),
                "kbench identity": lambda: kernel_ab._words(rng, 256),
                "B6 reads": lambda: kernel_ab._codes(rng, 256, 256, 256),
                "B6 gtdb": lambda: kernel_ab._codes(rng, 256, 256, 150),
                "B9 reads": lambda: kernel_ab._codes(rng, 512, 256, 256,
                                                     True),
                }[case]()
        assert kernel_ab._equal(getattr(old, wrapper)(**args),
                                getattr(new, wrapper)(**args))
    finally:
        for name in [m for m in sys.modules if m == kernel_ab._OLD
                     or m.startswith(kernel_ab._OLD + ".")]:
            del sys.modules[name]


@pytest.mark.parametrize("counts, clocks", [
    (dict(alu=64), 1.0),                      # the ALU pipe alone
    (dict(alu=64, fma=64), 1.0),              # IMAD beside it, FMA pipe
    (dict(alu=64, fma=64, either=64), 1.5),   # 128 lanes a clock of issue
    (dict(alu=16, quarter=16), 1.0),          # POPC and BREV, 16 a clock
])
def test_chip_smoke_sm_clocks(counts, clocks):
    import chip_smoke
    assert chip_smoke._sm_clocks(**counts) == clocks


def test_chip_smoke_window_bound():
    """A window costs its 29 ALU-pipe instructions; [65,536, 256] reads of
    length 256 at k = 31 (226 windows each) need 0.0257 ms at least."""
    import chip_smoke
    assert chip_smoke.WINDOW_CLOCKS == 29 / 64
    ms = (65536 * 226 * chip_smoke.WINDOW_CLOCKS
          / chip_smoke.H100_SM_CLOCKS_PER_S * 1e3)
    assert ms == pytest.approx(0.02568, rel=1e-3)
