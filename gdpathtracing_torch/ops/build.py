"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source ``csrc/<name>.cu`` exports a plain C function, so it
compiles in seconds without PyTorch's headers. The shared library lands in
``build/gdpathtracing_torch/`` at the repository root (listed in
.gitignore), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags: a changed source is rebuilt, an unchanged
one is loaded as it is. Nothing is built at import time; the first CUDA
launch of a kernel builds it, and :func:`load_libraries` builds several at
once, one nvcc process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

from gdpathtracing_torch.utils.telemetry import SPANS

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
    build_seconds: float  # wall time of its nvcc (0.0 when an up-to-date
    #                       build was loaded; builds run in parallel)
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


# One library per source; closest_hit_classic.cu exports two entry points
# (kernels 8 and 9); trace_bvh.cu is the BVH traversal (render/traverse.py),
# regen_shade.cu regen's shading (ops/shade.py), regen_lanes.cu its lane
# bookkeeping (ops/lanes.py), path_shade.cu the primal BVH loop's shading
# (ops/shade.py).
KERNELS = ("closest_hit_rows", "occlusion", "closest_hit_rows_nee",
           "closest_hit_sc_lite", "closest_hit_rows_sc", "soft_occlusion",
           "mega_step", "fused_paths", "march_step_sc", "closest_hit_classic",
           "trace_bvh", "regen_shade", "regen_lanes", "path_shade")

_loaded: dict[str, Library] = {}


def _library_path(name: str) -> Path:
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def load_libraries(names=KERNELS) -> list[Library]:
    """Build (where needed, in parallel) and load ``csrc/<name>.cu`` for
    each name. Raises with nvcc's output if a build fails, after every
    started nvcc has ended."""
    with SPANS.kernels_load:
        todo = [n for n in dict.fromkeys(names) if n not in _loaded]
        builds = {}
        for name in todo:
            so = _library_path(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            builds[name] = (proc, tmp, so, time.perf_counter())
        done, failed = {}, []
        for name, (proc, tmp, so, t0) in builds.items():
            log, _ = proc.communicate()
            done[name] = (time.perf_counter() - t0, log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed to build {name}.cu:\n{log}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            so = _library_path(name)
            seconds, log = done.get(name, (0.0, ""))
            _loaded[name] = Library(ctypes.CDLL(str(so)), so, seconds, log)
    return [_loaded[n] for n in names]


def load_library(name: str) -> Library:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return load_libraries((name,))[0]
