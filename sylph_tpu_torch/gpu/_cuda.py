"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into ``build/kernels/<name>-<hash>.so`` (a plain C interface, loaded with
ctypes) the first time a kernel is launched on a CUDA tensor; all sources
build in parallel, one nvcc process each. Importing the package, or running
anything on the CPU, never needs nvcc.

Every C entry point returns ``cudaGetLastError()`` after its launch and
``check`` raises on a non-zero code. ``LAUNCHES`` counts kernel launches per
kernel; a wrapper bumps its count only where it launches its kernel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("fill", "join", "repack", "seed", "seed_pack", "kbench")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the microkernels of csrc/kbench.cu, one count per kernel and chain length
KBENCH_KERNELS = ("identity",) + tuple(
    f"{k}_x{n}" for k in ("alu", "lane_roll", "half_roll", "warp_roll",
                          "sublane_roll", "rank", "barrier", "funnel")
    for n in (16, 64))

LAUNCHES = {"B1_fill": 0, "B2_join_codes_compact": 0, "B3_repack": 0,
            "B4_join_codes": 0, "B5_join_counts": 0,
            "B5p_bucket_join": 0, "B7_seed": 0, "B8_repack2": 0,
            "B2b_join_codes_compact_batched": 0,
            "B4b_join_codes_batched": 0, "B5b_join_counts_batched": 0,
            "B6_seed_pack": 0, "B9_seed_pack_t": 0, "B10_seed_compact": 0,
            "B11_repack_rows": 0, "B12_repack1_rows": 0,
            **{f"kbench_{k}": 0 for k in KBENCH_KERNELS}}
BUILD_LOG = {}                 # source name -> nvcc/ptxas output
BUILD_SECONDS = {}             # source name -> wall seconds of its nvcc

_LIBS = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()   # kernels launch from the ingest's threads


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """Add one to ``name``'s launch count (wrappers call it where they
    launch their kernel, and nowhere else)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from sylph_tpu_torch/csrc "
                           "at their first launch on a CUDA tensor")
    return found


def _target(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every source in ``names`` that has no up-to-date library,
    one nvcc each, all started together. Returns {name: library path};
    raises with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (p, tmp, out, t0) in procs.items():
        log, _ = p.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log.decode(errors="replace")
        if p.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(BUILD_LOG[n] for n in failed))
    return {name: _target(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building (all sources,
    in parallel) on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_all()
            for n, path in paths.items():
                if n not in _LIBS:
                    _LIBS[n] = _bind(ctypes.CDLL(path))
            lib = _LIBS[name]
        return lib


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {                 # C entry point -> argument types
    "fill_cells": [_P, _P] + [_I64] * 7 + [_P, _P, _P],
    "join_launch": [_I32, _P, _P, _P, _P] + [_I64] * 9 + [_P, _P, _P],
    "repack_launch": [_P] + [_I64] * 4 + [_P, _P],
    "repack64_launch": [_P] + [_I64] * 4 + [_P, _P],
    "seed_launch": [_P, _P, _I64, _I32, _I32, ctypes.c_uint64, _P, _P, _P],
    "seed_pack_launch": [_P, _P, _I64, _I32, _I32, ctypes.c_uint64, _I32,
                         _I32, _P, _P],
    "seed_pack_t_launch": [_P, _P, _I64, _I32, _I32, ctypes.c_uint64, _I32,
                           _P, _P],
    "kbench_launch": [_I32, _I32, _P, _P, _I64, _P],
}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.kernel_error_string.restype = ctypes.c_char_p
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    for name, args in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank
    ``ndim`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: rank {t.dim()}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
