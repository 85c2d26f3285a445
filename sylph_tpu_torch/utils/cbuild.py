"""Build and load the port's host C sources (``sylph_tpu_torch/native/*.c``).

Each source is compiled with ``cc -O3`` at its first use into
``build/native/lib<name>-<hash>.so`` (the hash covers the source and the
flags), beside the repository, never into the JAX package's ``native/``
directory, so the two packages never load each other's library. A failed
build raises: the port's read sketching needs these libraries.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")

_LOCK = threading.Lock()
_LIBS = {}


def _target(name: str, flags: Sequence[str]) -> str:
    with open(os.path.join(NATIVE_SRC, f"{name}.c"), "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _build(name: str, flags: Sequence[str]) -> str:
    out = _target(name, flags)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["cc", "-O3", "-shared", "-fPIC", *flags, "-o", tmp,
           os.path.join(NATIVE_SRC, f"{name}.c")]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run the C compiler for {name}.c: {e}")
    if r.returncode != 0:
        raise RuntimeError(f"cc failed for sylph_tpu_torch/native/{name}.c:"
                           f"\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders agree
    return out


def load(name: str, flags: Sequence[str],
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.c``, built on first use;
    ``bind`` sets its argument and result types once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name, flags))
            bind(lib)
            _LIBS[name] = lib
        return lib
