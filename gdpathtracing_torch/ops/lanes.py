"""Regen's lane bookkeeping in two kernel launches (``csrc/regen_lanes.cu``).

After each regen iteration's shading the lanes are sorted (live lanes by
the Morton cell of their origin and the octant of their direction, then
the lanes that ended now, then those dead before), permuted, the ended
paths appended to the retirement log, and the dead lanes refilled with the
next unstarted paths of the frame. In PyTorch that is ~245 launches an
iteration (render/regen.py's torch glue); the kernels do it in two around
the stable ``torch.argsort`` that stays between them:

- :func:`regen_lane_key` writes every lane's sort key;
- :func:`regen_lane_refill` gathers the permuted stacks, appends the
  freshly dead block to the log and spawns the fresh paths (camera ray and
  PCG2D stream) in the lanes behind the live ones.

Each wrapper

- on a CUDA tensor launches its kernel (built by nvcc at first use,
  ops/build.py) and counts the launch in ``<wrapper>.launches``;
- on a CPU tensor runs its plain version, regen's torch glue on the same
  inputs (:func:`regen_lane_key_plain`, :func:`regen_lane_refill_plain`).

Regen picks them once a frame, the same on the CPU and the card
(:func:`lanes_entry`): the Morton-sorted, log-retiring lanes of the
(17, n) / (6, n) layout, without the march or fused NEE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdpathtracing_torch.config import Jitter, RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops.intersect import _launch
from gdpathtracing_torch.ops.shade import NF, NI
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.integrator import morton_octant_key

_JITTER = (Jitter.NONE, Jitter.UNIFORM, Jitter.GAUSS, Jitter.CIRCLE)


def sorts_lanes(config: RenderConfig) -> bool:
    """Whether regen sorts its lanes by a spatial key (the reference's
    rule): ``sort_rays``, by default on PALLAS only, and only where the
    lanes are permuted at all (``compact_rays`` not False)."""
    sort = config.sort_rays
    if sort is None:
        sort = config.traversal == Traversal.PALLAS
    return bool(sort) and config.compact_rays is not False


def lanes_entry(config: RenderConfig, march: bool, fuse: bool) -> bool:
    """Whether regen's lane glue runs in the two kernels: lanes sorted
    (:func:`sorts_lanes`) by the Morton key and retired to the log,
    neither marching (``march``) nor fusing NEE (``fuse``), as regen
    decides both."""
    return (sorts_lanes(config) and config.regen_sort_key != "chunk"
            and config.regen_retire == "log" and not march and not fuse)


class LaneSpawn(NamedTuple):
    """What starting a path of the frame takes: the camera (on the
    frame's device), the config (jitter, spp), the frame index and
    ``cam``, the (13,) float32 the kernel reads: the camera's transform
    row-major, then the tan of its half FOV. :func:`lane_spawn` builds it
    once a frame."""

    camera: Camera
    config: RenderConfig
    frame_index: int
    cam: torch.Tensor


def lane_spawn(camera: Camera, config: RenderConfig,
               frame_index: int) -> LaneSpawn:
    """The frame's :class:`LaneSpawn`; ``camera`` on the frame's device."""
    cam = torch.cat([camera.transform.detach().reshape(12),
                     camera.half_tan().detach().reshape(1)])
    return LaneSpawn(camera, config, int(frame_index), cam)


def spawn_paths(sp: LaneSpawn, path_id: torch.Tensor):
    """Camera ray and RNG stream of path ``path_id`` (pixel-major within
    each sample), as the standard renderer spawns it: (Ray, seed)."""
    w, n_pix = sp.camera.width, sp.camera.width * sp.camera.height
    pix = path_id % n_pix
    sample = torch.div(path_id, n_pix, rounding_mode="floor")
    seed = rng.prng_seed(pix % w, torch.div(pix, w, rounding_mode="floor"),
                         sp.frame_index * sp.config.spp + sample)
    return sp.camera.generate_rays(pix, seed, sp.config)


def regen_lane_key_plain(fs, alive, dead_now, cell_lo, cell_span):
    """:func:`regen_lane_key` in PyTorch: regen's Morton key."""
    return torch.where(alive,
                       morton_octant_key(Vec3(*fs[0:3]), Vec3(*fs[3:6]),
                                         cell_lo, cell_span),
                       torch.where(dead_now, 1 << 14, 1 << 15)).to(
        torch.int32)


def regen_lane_key(fs: torch.Tensor, alive: torch.Tensor,
                   dead_now: torch.Tensor, cell_lo: torch.Tensor,
                   cell_span: torch.Tensor) -> torch.Tensor:
    """The (n,) int32 sort key of the lanes of the (NF, n) ``fs`` stack
    (render/regen.py layout, unit column stride): for the ``alive`` lanes
    integrator.py ``morton_octant_key`` of their origin and direction in
    the frame (``cell_lo``, ``cell_span``) of ``morton_frame``, then
    ``dead_now`` 1 << 14, the others 1 << 15. Every key is below 2^16,
    so a stable sort orders them as the int64 key would.

    CUDA tensors launch the kernel (counted in ``regen_lane_key.launches``);
    CPU tensors run :func:`regen_lane_key_plain`."""
    n, dev = _check_mask(alive, "alive")
    _check_mask(dead_now, "dead_now", n, dev)
    _check_stack("fs", fs, NF, n, torch.float32, dev)
    for name, x in (("cell_lo", cell_lo), ("cell_span", cell_span)):
        _check_stack(name, x.reshape(1, -1), 1, 3, torch.float32, dev)
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type == "cpu":
        return regen_lane_key_plain(fs, alive, dead_now, cell_lo, cell_span)
    key = torch.empty(n, dtype=torch.int32, device=dev)
    _launch("regen_lane_key", (fs, alive, dead_now, cell_lo, cell_span, key),
            n, fs.stride(0), source="regen_lanes", wrapper=regen_lane_key)
    return key


regen_lane_key.launches = 0


def regen_lane_refill_plain(perm, fs, ints, log_f, log_i, n_alive: int,
                            n_fresh: int, retired: int, next_path: int,
                            sp: LaneSpawn):
    """:func:`regen_lane_refill` in PyTorch: regen's torch glue after the
    sort."""
    from gdpathtracing_torch.render import regen as rg

    size, dev = perm.shape[0], perm.device
    n_paths = sp.camera.width * sp.camera.height * sp.config.spp
    lane = torch.arange(size, device=dev)
    fs, ints = fs[:, perm], ints[:, perm]
    alive = lane < n_alive
    # the freshly dead block, appended in one copy
    fresh = slice(n_alive, n_alive + n_fresh)
    log_f[:, retired:retired + n_fresh] = fs[rg._LOG_F, fresh]
    log_i[0, retired:retired + n_fresh] = torch.clamp(
        ints[rg._STEPS, fresh], max=rg._STEPS_MAX)
    log_i[1:, retired:retired + n_fresh] = ints[[rg._SEGS, rg._PID], fresh]
    # refill dead lanes from the path pool
    dead = ~alive
    new_id = next_path + torch.cumsum(dead, 0) - 1
    can = dead & (new_id < n_paths)
    new_id = torch.clamp(new_id, max=n_paths - 1)
    ray_new, seed_new = spawn_paths(sp, new_id)
    spawn_f = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0, -1.0,
                            sp.camera.far, 0.0, 0.0, 0.0], device=dev)
    fresh_f = torch.cat([torch.stack([*ray_new.o, *ray_new.d]),
                         spawn_f[:, None].expand(-1, size)])
    fresh_i = torch.cat([torch.stack([*seed_new, new_id]),
                         torch.zeros((NI - 3, size), dtype=torch.int64,
                                     device=dev)])
    fs = torch.where(can, fresh_f, fs)
    ints = torch.where(can, fresh_i, ints)
    return fs, ints, alive | can


def regen_lane_refill(perm: torch.Tensor, fs: torch.Tensor,
                      ints: torch.Tensor, log_f: torch.Tensor,
                      log_i: torch.Tensor, n_alive: int, n_fresh: int,
                      retired: int, next_path: int, sp: LaneSpawn):
    """After ``perm`` = ``argsort(regen_lane_key(...), stable=True)`` over
    ``n`` lanes, of which ``n_alive`` go on and ``n_fresh`` ended now:
    permute the lane stacks ``fs`` (NF, n) f32 and ``ints`` (NI, n)
    int64 (unit column stride), append the ended paths to the log
    (``log_f`` (7, L) f32, ``log_i`` (3, L) int64, contiguous; columns
    ``retired`` on) and refill the lanes behind the live ones with the
    paths ``next_path`` on, while the frame of ``sp`` has any. Returns the
    new stacks and the (n,) bool mask of the lanes that hold a path.

    CUDA tensors launch the kernel (counted in
    ``regen_lane_refill.launches``); CPU tensors run
    :func:`regen_lane_refill_plain`. Raises on anything the kernel cannot
    read."""
    if perm.dim() != 1 or perm.dtype != torch.int64 \
            or not perm.is_contiguous() or perm.numel() == 0:
        raise ValueError("perm must be a contiguous non-empty int64 vector")
    n, dev = perm.shape[0], perm.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    _check_stack("fs", fs, NF, n, torch.float32, dev)
    _check_stack("ints", ints, NI, n, torch.int64, dev)
    cols = log_f.shape[-1]
    _check_stack("log_f", log_f, 7, cols, torch.float32, dev)
    _check_stack("log_i", log_i, 3, cols, torch.int64, dev)
    _check_stack("cam", sp.cam.reshape(1, -1), 1, 13, torch.float32, dev)
    if not (log_f.is_contiguous() and log_i.is_contiguous()
            and sp.cam.is_contiguous()):
        raise ValueError("log_f, log_i and the spawn's cam must be "
                         "contiguous")
    n_paths = sp.camera.width * sp.camera.height * sp.config.spp
    if not (0 <= n_alive and 0 <= n_fresh and n_alive + n_fresh <= n
            and 0 <= retired and retired + n_fresh <= cols
            and 0 <= next_path <= n_paths and n_paths + n < 1 << 31):
        raise ValueError(f"counts out of range: n_alive {n_alive}, n_fresh "
                         f"{n_fresh}, retired {retired}, next_path "
                         f"{next_path}, {n_paths} paths, {n} lanes, {cols} "
                         f"log columns")
    if dev.type == "cpu":
        return regen_lane_refill_plain(perm, fs, ints, log_f, log_i, n_alive,
                                       n_fresh, retired, next_path, sp)
    out = (torch.empty((NF, n), dtype=torch.float32, device=dev),
           torch.empty((NI, n), dtype=torch.int64, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev))
    frame = (sp.frame_index * sp.config.spp) & 0xFFFFFFFF
    _launch("regen_lane_refill", (perm, fs, ints, sp.cam, log_f, log_i, *out),
            n, fs.stride(0), ints.stride(0), cols, n_alive, n_fresh, retired,
            next_path, n_paths, sp.camera.width, sp.camera.height,
            frame - (1 << 32) if frame >= 1 << 31 else frame,
            _JITTER.index(sp.config.jitter),
            floats=(sp.camera.aspect, sp.camera.far), source="regen_lanes",
            wrapper=regen_lane_refill)
    return out


regen_lane_refill.launches = 0


def _check_mask(x, name, n=None, dev=None):
    """Raise unless ``x`` is a contiguous non-empty bool vector (of ``n``
    on ``dev`` where given); returns its length and device."""
    if x.dim() != 1 or x.dtype != torch.bool or not x.is_contiguous() \
            or x.numel() == 0 or (n is not None and x.shape[0] != n) \
            or (dev is not None and x.device != dev):
        raise ValueError(f"{name} must be a contiguous non-empty bool vector"
                         + (f" of {n} on {dev}" if n is not None else ""))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.shape[0], x.device


def _check_stack(name, x, rows, n, dtype, dev):
    """Raise unless ``x`` is (rows, n) of ``dtype`` with unit column
    stride on ``dev``."""
    if x.dim() != 2 or x.shape != (rows, n) or x.dtype != dtype \
            or x.stride(1) != 1 or x.device != dev:
        raise ValueError(f"{name} must be ({rows}, {n}) {dtype} with unit "
                         f"column stride on {dev}, got {tuple(x.shape)} "
                         f"{x.dtype} strides {x.stride()} on {x.device}")
