"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source ``csrc/<name>.cu`` exports a plain C function, so it
compiles in seconds without PyTorch's headers. The shared library lands in
``build/gdpathtracing_torch/`` at the repository root (listed in
.gitignore), named by a hash of the source and the flags: a changed source
is rebuilt, an unchanged one is loaded as it is. Nothing is built at import
time; the first CUDA launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gdpathtracing_torch"

# -fmad=false: no a*b+c contraction, so the kernels round exactly like their
# plain PyTorch versions. No --use_fast_math: division stays IEEE and
# denormals are kept. -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class Library(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date build was loaded
    log: str              # nvcc/ptxas output of the build ("" when loaded)


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> Library:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{key}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
        os.replace(tmp, so)
    return Library(ctypes.CDLL(str(so)), so, seconds, log)
