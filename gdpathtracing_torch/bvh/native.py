"""ctypes binding of the C++ SAH builder (``native/bvh_builder.cpp``) — port
of gdpathtracing_tpu/bvh/native.py.

The source is the JAX package's, read where it lies; the port compiles it
with g++ into ``build/gdpathtracing_torch/`` at the repository root (listed
in .gitignore, beside the CUDA kernels of ops/build.py), named by a hash of
the source and the flags, and never writes into ``native/``. The first use
builds it; ``available()`` is False where no toolchain builds it, and
``bvh.blas.BLASBuilder(backend="auto")`` then takes the NumPy builder. Both
run the same algorithm and give bit-identical trees
(tests/test_torch_loaders.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "bvh_builder.cpp"
BUILD_DIR = _ROOT / "build" / "gdpathtracing_torch"
# -ffp-contract=off: no FMA contraction, so the double arithmetic rounds
# exactly like NumPy's and the trees equal the NumPy builder's bit for bit.
# No -march=native: the library lands in the checkout, which may be copied
# to and run on another host.
FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_error: str | None = None


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    key = hashlib.sha256(SRC.read_bytes())
    key.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libgdpt_bvh-{key.hexdigest()[:16]}.so"


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                try:
                    subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                                   check=True, capture_output=True, text=True)
                    os.replace(tmp, so)
                finally:
                    tmp.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(so))
            f = lib.gdpt_build_blas
            f.restype = ctypes.c_int32
            f.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            _error = getattr(e, "stderr", None) or str(e)
        return _lib


def available() -> bool:
    """Whether the native builder builds and loads here."""
    return _load() is not None


def build_blas_native(tri_pos: np.ndarray, max_leaf: int = 4):
    """Build one mesh's BVH natively. ``tri_pos``: (n, 3, 3) float32.

    Returns (node_min, node_max, left, right, first, count, order) with the
    node arrays trimmed to the used count; ``order`` is the triangle
    permutation (BVH position i ← original triangle order[i]). Raises
    RuntimeError, with the compiler's message, where the library does not
    build."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native BVH builder unavailable: {_error}")
    tri = np.ascontiguousarray(tri_pos, dtype=np.float32).reshape(-1, 9)
    n = len(tri)
    cap = 2 * n
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    left = np.zeros(cap, np.int32)
    right = np.zeros(cap, np.int32)
    first = np.zeros(cap, np.int32)
    count = np.zeros(cap, np.int32)
    order = np.zeros(n, np.int32)

    def fptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def iptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    n_nodes = lib.gdpt_build_blas(fptr(tri), n, max_leaf, fptr(node_min),
                                  fptr(node_max), iptr(left), iptr(right),
                                  iptr(first), iptr(count), iptr(order))
    if n_nodes < 0:
        raise RuntimeError(f"gdpt_build_blas failed: {n_nodes}")
    return (node_min[:n_nodes], node_max[:n_nodes], left[:n_nodes],
            right[:n_nodes], first[:n_nodes], count[:n_nodes], order)
