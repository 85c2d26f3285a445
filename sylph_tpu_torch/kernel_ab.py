"""Kernels of two trees of the port, in turns, in one process on the card.

    python -m sylph_tpu_torch.kernel_ab OLD_TREE [--reps 20] [--seed 0]
                                        [--case NAME ...]

OLD_TREE is the root of another checkout of the repo (an earlier commit
unpacked with ``git archive`` into a directory that .gitignore lists). Its
``sylph_tpu_torch`` is imported as a package of its own, so each tree
launches its kernels through its own wrappers, whatever their C interface,
and builds its own ``csrc`` into its own ``build/kernels/``. For each case
of ``CASES`` both trees' wrappers run on the same inputs, made from
``--seed``; both outputs are held bit for bit against the plain version
(this tree's wrapper on CPU copies of the inputs) and a mismatch raises;
then both are timed by torch.profiler device time in turns (old, new, new,
old). ``--case`` (repeatable) keeps only the named cases. Prints the
card's name and power limit, a line a case, the SASS instruction counts of
both trees' kernels and one JSON line. Card only: without CUDA it says so
and exits 2.
"""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .gpu import _cuda

_OLD = "kernel_ab_old"             # the other tree's package, as imported


def _reads(rng, N, L, n):
    """[N, L/16] packed words of random bases, every row ``n`` bases long,
    at c = 200, k = 31."""
    from .engine.device_sketch import _pack16_rows
    bases = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    return dict(packed=torch.from_numpy(_pack16_rows(bases).view(np.int32)),
                lengths=torch.full((N,), n, dtype=torch.int32), c=200, k=31)


def _slice(rng, B, nt, CS, n_entries, n_slots):
    """A sorted slice of ``n_entries`` uniform hashes over B buckets (the
    cell grid's whole range, base 0; high words below 2^31, as every hash
    at c >= 2), weights 1-5 with a tenth 0 (folded), KEY_PAD-tailed to
    ``n_slots``."""
    width = (1 << 31) // B
    hi = rng.integers(0, B * width, size=n_entries)
    keys = np.sort(np.unique((hi.astype(np.int64) << 32)
                             | rng.integers(0, 1 << 32, size=n_entries)))
    w = rng.integers(1, 6, size=keys.size).astype(np.int32)
    w[rng.random(keys.size) < 0.1] = 0
    k = np.full(n_slots, -1, np.int64)
    ww = np.zeros(n_slots, np.int32)
    k[:keys.size], ww[:keys.size] = keys, w
    return dict(skey=torch.from_numpy(k), sw=torch.from_numpy(ww), base=0,
                width=width, B=B, CS=CS, nt=nt,
                subwidth=-(-width // nt) if nt > 1 else 0)


def _pad_stream(rng, n, dtype, dens, row, cap):
    """A repack input: n slots live at density ``dens`` (int32 codes below
    2^31, int64 keys below 2^62), pad -1 else, with its window geometry."""
    hi = 1 << (31 if dtype == np.int32 else 62)
    v = rng.integers(0, hi, size=n, dtype=np.int64).astype(dtype)
    v[rng.random(n) > dens] = -1
    return dict(v=torch.from_numpy(v), row=row, cap=cap)


def _codes(rng, N, L, n, t=False):
    """[N, L] random 2-bit codes, every read ``n`` bases long, at c = 200,
    k = 31: B6's inputs at the pipeline's 13 lanes, or (``t``) B9's, the
    codes transposed to one read a column."""
    bases = torch.from_numpy(rng.integers(0, 4, size=(N, L)).astype(np.uint8))
    lens = torch.full((N,), n, dtype=torch.int32)
    if t:
        return dict(bases_t=bases.t().contiguous(), lengths=lens, c=200, k=31)
    return dict(bases=bases, lengths=lens, c=200, k=31, lanes=13)


def _words(rng, R):
    return dict(kind="identity", x=torch.from_numpy(
        rng.integers(0, 1 << 32, size=(R, 256), dtype=np.uint32)
        .view(np.int32)), n=0)


# name -> (module, wrapper, profiler kernel name, csrc source, inputs)
CASES = {
    "B7 reads": ("gpu.seeding", "seed_packed", "seed_kernel", "seed",
                 lambda rng: _reads(rng, 65536, 256, 150)),
    "B7 genome": ("gpu.seeding", "seed_packed", "seed_kernel", "seed",
                  lambda rng: _reads(rng, 2048, 4096, 4096)),
    "B1 grange": ("gpu.bucket_fill", "bucket_fill", "fill_cells_kernel",
                  "fill", lambda rng: _slice(rng, 32768, 4, 16, 241_000,
                                             253_952)),
    "B1 deep": ("gpu.bucket_fill", "bucket_fill", "fill_cells_kernel",
                "fill", lambda rng: _slice(rng, 32768, 4, 36, 1_450_000,
                                           1_523_712)),
    "B1 whole": ("gpu.bucket_fill", "bucket_fill", "fill_cells_kernel",
                 "fill", lambda rng: _slice(rng, 65536, 1, 256, 5_300_000,
                                            8_388_608)),
    "B3 grange": ("gpu.bucket_fill", "repack1_flat", "repack_kernel",
                  "repack", lambda rng: _pad_stream(rng, 14_155_776, np.int32,
                                                    0.0122, 8192, 2816)),
    "B8 reads": ("gpu.bucket_fill", "repack2_flat", "repack_kernel",
                 "repack", lambda rng: _pad_stream(rng, 2_162_688, np.int64,
                                                   0.0483, 32768, 1536)),
    "kbench identity": ("kbench", "launch", "kb_identity", "kbench",
                        lambda rng: _words(rng, 65536)),
    "B6 reads": ("gpu.seed_pack", "seed_pack", "seed_pack_rows", "seed_pack",
                 lambda rng: _codes(rng, 65536, 256, 256)),
    "B6 gtdb": ("gpu.seed_pack", "seed_pack", "seed_pack_rows", "seed_pack",
                lambda rng: _codes(rng, 65536, 256, 150)),
    "B9 reads": ("gpu.seed_pack", "seed_pack_t", "seed_pack_cols",
                 "seed_pack", lambda rng: _codes(rng, 65536, 256, 256, True)),
}


def _load_tree(root: str) -> None:
    """Import ``root/sylph_tpu_torch`` as the package ``kernel_ab_old``
    (its imports are relative, so it stays apart from this tree)."""
    pkg = os.path.join(os.path.abspath(root), "sylph_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        _OLD, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_OLD] = mod
    spec.loader.exec_module(mod)


def sass_count(lib_path: str) -> dict:
    """SASS instructions of each kernel in a built library, by
    ``cuobjdump -sass``: {kernel: {"total": n, opcode: n, ...}}."""
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if line.strip().startswith("Function :"):
            cur = out.setdefault(line.split(":", 1)[1].strip(),
                                 {"total": 0})
        elif cur is not None and line.lstrip().startswith("/*") and \
                "*/" in line and line.split("*/", 1)[1].strip(" ;"):
            op = line.split("*/", 1)[1].split()
            op = op[1] if op[0].startswith("@") else op[0]
            op = op.split(".")[0]
            cur["total"] += 1
            cur[op] = cur.get(op, 0) + 1
    return out


def _equal(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a.cpu(), b)
        for a, b in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sylph_tpu_torch.kernel_ab")
    ap.add_argument("old_tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--case", action="append", choices=sorted(CASES),
                    help="time only this case (repeatable)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab needs an NVIDIA GPU (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"card: {_cuda.card_line()}")
    _load_tree(a.old_tree)
    rng = np.random.default_rng(a.seed)
    out, sources = {}, set()
    for name, (module, wrapper, kernel, source, inputs) in CASES.items():
        args = inputs(rng)      # for every case: --case moves no inputs
        if a.case and name not in a.case:
            continue
        sources.add(source)
        want = getattr(importlib.import_module(f"{__package__}.{module}"),
                       wrapper)(**args)
        on_card = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                   for k, v in args.items()}
        fns = {tag: (lambda f=getattr(importlib.import_module(
                   f"{pkg}.{module}"), wrapper): f(**on_card))
               for tag, pkg in (("old", _OLD), ("new", __package__))}
        for tag, fn in fns.items():
            if not _equal(fn(), want):
                raise RuntimeError(f"{name}: the {tag} tree's kernel "
                                   "differs from the plain version")
        ms = {"old": [], "new": []}
        for tag in ("old", "new", "new", "old"):
            ms[tag].append(_cuda.device_ms(fns[tag], kernel, a.reps))
        out[name] = ms
        print(f"{name}: old {ms['old']} ms, new {ms['new']} ms "
              "(profiler device time a launch; both bit-identical)")
    old_cuda = importlib.import_module(f"{_OLD}.gpu._cuda")
    sass = {tag: {s: sass_count(c._target(s)) for s in sorted(sources)}
            for tag, c in (("old", old_cuda), ("new", _cuda))}
    for tag, by_src in sass.items():
        for s, counts in by_src.items():
            print(f"{tag} {s}.cu SASS: {counts}")
    if _cuda.PROFILE_MISSES:
        print("profiler windows that showed another number of launches "
              "(kernel, launches, reps), each taken again: "
              f"{_cuda.PROFILE_MISSES}")
    print(json.dumps({"card": smi, "device_ms": out, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
