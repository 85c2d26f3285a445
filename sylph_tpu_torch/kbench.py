"""Microbenchmarks of the seed kernels' primitives on an NVIDIA H100 (the
Hopper counterpart of scripts/kbench.py, which times Pallas kernels on a
TPU).

    python -m sylph_tpu_torch.kbench

runs on the card only: without CUDA it says so and exits 2. On the
[65,536, 256] batch of 32-bit words that scripts/kbench.py uses (64 MB,
carried as int32 bit patterns with uint32 arithmetic) it times, with CUDA
events, the microkernels of csrc/kbench.cu (see its header: a copy, ALU
chains, lane rolls through shared memory at full and half width, warp
shuffle rolls, sublane rolls, and the ranking pass, barriers and funnel
shifts of B6's first design, each chain at 16 and 64 steps) and then the
real kernels: B6 (gpu/seed_pack.py::seed_pack) at the pipeline's 13 lanes
and at 128, B9 (seed_pack_t) alone, and the transpose plus B9, at c = 200,
k = 31. Every kernel is first held bit for bit against its plain PyTorch
version (below, or gpu/seed_pack.py's); a mismatch raises. Each line
prints its milliseconds, its cost per step over the identity's time (as
scripts/kbench.py does) and, for the real kernels, Gbp/s.

Importing this module builds nothing: the kernels build at their first
launch on a CUDA tensor.
"""

import ctypes
import json
import sys

import torch

from .gpu import _cuda

N, L = 1 << 16, 256            # one seeding batch: [65,536, 256]
TILE = 256                     # rows of a sublane-roll tile (Pallas block)
STEPS = (16, 64)
C, K = 200, 31
_M32 = 0xFFFFFFFF
# C entry kinds of csrc/kbench.cu
_KINDS = {"identity": 0, "alu": 1, "lane_roll": 2, "half_roll": 3,
          "warp_roll": 4, "sublane_roll": 5, "rank": 6, "barrier": 7,
          "funnel": 8}
# int32 instructions a word and step, for the bound (0: data movement, the
# bytes bound it): alu one, its shift and add counted as one instruction
# (on the H100 at 700 W alu x64 ran in 0.0779 ms, below the 0.128 ms that
# two a step at the INT32 rate would take, so the compiler fuses them or
# issues them on two pipes); funnel one SHF; rank a shift, an and, two
# popc, an and with the lane mask and two adds
_OPS = {"identity": 0, "alu": 1, "barrier": 1, "funnel": 1, "rank": 7,
        "lane_roll": 0, "half_roll": 0, "warp_roll": 0, "sublane_roll": 0}
# the scripts/kbench.py body each line stands for
_REPLACES = {"identity": ":90", "alu": ":69", "barrier": ":69",
             "lane_roll": ":55", "half_roll": ":55", "warp_roll": ":55",
             "sublane_roll": ":78", "rank": ":45", "funnel": ":45"}


def _shift(i: int) -> int:
    return 1 + i % 7


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values as int64."""
    return x.to(torch.int64) & _M32


def _i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 bit patterns."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def identity_plain(x: torch.Tensor, n: int = 0) -> torch.Tensor:
    return x.clone()


def alu_chain_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """y = x; y += x >> (1 + i % 7) for i < n, on uint32 with wraparound
    (scripts/kbench.py:69-75). Also the barrier line's function."""
    u = _u32(x)
    a = u.clone()
    for i in range(n):
        a = (a + (u >> _shift(i))) & _M32
    return _i32(a)


def funnel_chain_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """y = x; y = low 32 bits of (x:y) >> (1 + i % 7) for i < n."""
    u = _u32(x)
    a = u.clone()
    for i in range(n):
        s = _shift(i)
        a = ((a >> s) | (u << (32 - s))) & _M32
    return _i32(a)


def rank_chain_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """The sum over i < n of each lane's exclusive rank in its 256-lane row
    under the predicate 'bit i % 31 of the word is set'."""
    u = _u32(x)
    acc = torch.zeros_like(u)
    for i in range(n):
        p = (u >> (i % 31)) & 1
        acc += torch.cumsum(p, dim=1) - p
    return acc.to(torch.int32)


def _roll_chain(v: torch.Tensor, steps: int, dim: int) -> torch.Tensor:
    for i in range(steps):
        v = torch.roll(v, _shift(i), dims=dim)
    return v


def lane_roll_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each 256-lane row rolled by 1 + i % 7 lanes, i < n
    (roll_chain(n, 256))."""
    return _roll_chain(x, n, 1)


def half_roll_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each 128-lane half rolled on its own, n // 2 steps
    (roll_chain(n, 128))."""
    R = x.shape[0]
    return _roll_chain(x.view(R, 2, 128), n // 2, 2).reshape(R, L)


def warp_roll_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each 32-lane group rolled by 1 + i % 7 lanes, i < n."""
    R = x.shape[0]
    return _roll_chain(x.view(R, L // 32, 32), n, 2).reshape(R, L)


def sublane_roll_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each 256-row tile rolled by 1 + i % 7 rows, i < n
    (sublane_roll_chain)."""
    R = x.shape[0]
    return _roll_chain(x.view(R // TILE, TILE, L), n, 1).reshape(R, L)


PLAIN = {"identity": identity_plain, "alu": alu_chain_plain,
         "barrier": alu_chain_plain, "funnel": funnel_chain_plain,
         "rank": rank_chain_plain, "lane_roll": lane_roll_plain,
         "half_roll": half_roll_plain, "warp_roll": warp_roll_plain,
         "sublane_roll": sublane_roll_plain}


def _total(steps: int, mod: int) -> int:
    return sum(_shift(i) for i in range(steps)) % mod


def library_call(kind: str, x: torch.Tensor, n: int):
    """One PyTorch call computing the same function, or None: a copy for
    the identity, one roll by the chain's total shift for the rolls."""
    R = x.shape[0]
    if kind == "identity":
        return x.clone()
    if kind == "lane_roll":
        return torch.roll(x, _total(n, L), dims=1)
    if kind == "half_roll":
        return torch.roll(x.view(R, 2, 128), _total(n // 2, 128), dims=2)
    if kind == "warp_roll":
        return torch.roll(x.view(R, L // 32, 32), _total(n, 32), dims=2)
    if kind == "sublane_roll":
        return torch.roll(x.view(R // TILE, TILE, L), _total(n, TILE), dims=1)
    return None


def launch(kind: str, x: torch.Tensor, n: int = 0) -> torch.Tensor:
    """Microkernel ``kind`` with a chain of n steps (16 or 64; 0 for the
    identity) on an int32 [R, 256] batch, R a multiple of 256. On a CPU
    tensor its plain version runs; on a CUDA tensor the kernel launches
    (counted as ``kbench_<kind>[_x<n>]``) or this raises."""
    if x.dim() != 2 or x.shape[1] != L or x.shape[0] % TILE:
        raise ValueError(f"x must be [R, {L}] with R a multiple of {TILE}, "
                         f"got {tuple(x.shape)}")
    if kind not in _KINDS:
        raise ValueError(f"unknown microkernel {kind!r}")
    if (kind == "identity") != (n == 0) or (n and n not in STEPS):
        raise ValueError(f"{kind}: steps must be "
                         f"{'0' if kind == 'identity' else STEPS}, got {n}")
    if x.device.type == "cpu":
        return PLAIN[kind](x, n)
    _cuda.require(x, "x", torch.int32, 2, x.device)
    y = torch.empty_like(x)
    lib = _cuda.library("kbench")
    with torch.cuda.device(x.device):
        rc = lib.kbench_launch(_KINDS[kind], n, _cuda.ptr(x), _cuda.ptr(y),
                               ctypes.c_int64(x.shape[0]),
                               _cuda.stream_ptr(x))
    _cuda.check(lib, rc, f"kbench_launch({kind}, {n})")
    _cuda.count_launch(counter(kind, n))
    return y


def counter(kind: str, n: int) -> str:
    """The launch-count name of a microkernel line."""
    return f"kbench_{kind}" + (f"_x{n}" if n else "")


def _ms(fn, reps: int) -> float:
    """Milliseconds a call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _same(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.equal(got, want):
        raise RuntimeError(f"kbench {name}: the kernel differs from its "
                           "plain version")


def _lines():
    """(kind, n) of every microkernel line, in table order."""
    yield "identity", 0
    for kind in ("alu", "lane_roll", "half_roll", "warp_roll",
                 "sublane_roll", "rank", "barrier", "funnel"):
        for n in STEPS:
            yield kind, n


def table(device="cuda", seed: int = 0, reps: int = 30) -> list:
    """Check and time every line on ``device`` (a CUDA device); returns one
    dict a line: name, kernel (its launch count) or None, ms, per_step_us
    (ms over the identity's, per step) or None, gbps or None, plain_ms,
    library_ms or None, library, nbytes and int32 ops (for the bound),
    replaces."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("kbench times the card: it needs a CUDA device")
    from .gpu import seed_pack as sp

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-(1 << 31), 1 << 31, (N, L), dtype=torch.int32,
                      device=dev, generator=g)
    rows, base = [], None
    for kind, n in _lines():
        got = launch(kind, x, n)
        _same(f"{kind} x{n}", got, PLAIN[kind](x, n))
        del got
        ms = _ms(lambda: launch(kind, x, n), reps)
        lib = library_call(kind, x, n)
        base = ms if base is None else base
        rows.append(dict(
            name=f"kbench {kind}" + (f" x{n}" if n else ""),
            kernel=counter(kind, n), ms=ms,
            per_step_us=(ms - base) / n * 1e3 if n else None, gbps=None,
            plain_ms=_ms(lambda: PLAIN[kind](x, n), 3),
            library_ms=(_ms(lambda: library_call(kind, x, n), 10)
                        if lib is not None else None),
            library=("clone" if kind == "identity" else "torch.roll"
                     if lib is not None else None),
            nbytes=2 * N * L * 4, ops=_OPS[kind] * n * N * L,
            replaces="scripts/kbench.py" + _REPLACES[kind]))
        del lib

    # the real kernels, on 2-bit codes of the same words, every read full
    codes = (x & 3).to(torch.uint8)
    codes_t = codes.t().contiguous()
    lens = torch.full((N,), L, dtype=torch.int32, device=dev)
    cap = sp.compact_cap(L, C)
    real = (
        (f"B6 seed_pack ({cap} lanes)",
         lambda: sp.seed_pack(codes, lens, c=C, k=K, lanes=cap),
         lambda: sp.seed_pack_plain(codes, lens, c=C, k=K, lanes=cap)),
        ("B6 seed_pack (128 lanes)",
         lambda: sp.seed_pack(codes, lens, c=C, k=K),
         lambda: sp.seed_pack_plain(codes, lens, c=C, k=K)),
        ("B9 seed_pack_t",
         lambda: sp.seed_pack_t(codes_t, lens, c=C, k=K),
         lambda: sp.seed_pack_t_plain(codes_t, lens, c=C, k=K)),
        ("transpose + B9",
         lambda: sp.seed_pack_t(codes.t().contiguous(), lens, c=C, k=K),
         lambda: sp.seed_pack_t_plain(codes_t, lens, c=C, k=K)))
    for name, kern, plain in real:
        _same(name, kern(), plain())
        ms = _ms(kern, reps)
        rows.append(dict(name=name, kernel=None, ms=ms, per_step_us=None,
                         gbps=N * L / (ms * 1e-3) / 1e9,
                         plain_ms=_ms(plain, 3), library_ms=None,
                         library=None, nbytes=None, ops=None, replaces=None))
    return rows


def format_row(r: dict) -> str:
    extra = ""
    if r["per_step_us"] is not None:
        extra = f"  ({r['per_step_us']:8.4f} us/step over the identity)"
    elif r["gbps"] is not None:
        extra = f"  ({r['gbps']:8.2f} Gbp/s)"
    return f"{r['name']:28s} {r['ms']:9.4f} ms{extra}"


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("kbench: no CUDA device; it times the card's kernels",
              file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0))
    rows = table()
    for r in rows:
        print(format_row(r))
    print(json.dumps({"kbench": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
