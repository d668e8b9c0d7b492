"""Regen's per-segment shading in one kernel launch (``csrc/regen_shade.cu``).

One regen iteration shades the segment each lane just traced, adds its
emission (or the sky's), records the first-hit AOVs and samples the next
direction. In PyTorch that is ~620 elementwise launches an iteration
(render/regen.py ``_shade_torch``); the kernel does it in one, reading the
lane stacks once and writing the new stacks, the ``alive`` / ``dead_now``
masks and their counts. Two entries, one a hit source:

- :func:`regen_shade` reads the winner rows of kernels 1 and 6;
- :func:`regen_shade_lite` reads the (t, eidx, steps) winners of the
  superchunk lite kernel (kernel 3), which returns no rows, and gathers
  what ops/intersect.py ``lite_epilogue`` and render/shading.py
  ``get_shading_data_fast`` gather (~650 launches an iteration in
  PyTorch).

Each wrapper

- on a CUDA tensor launches its kernel (built by nvcc at first use,
  ops/build.py) and counts the launch in ``<wrapper>.launches``;
- on a CPU tensor runs its plain version, regen's torch body on the same
  inputs (:func:`regen_shade_plain`, :func:`regen_shade_lite_plain`).

Regen picks the entry once a frame, the same on the CPU and the card
(:func:`shade_entry`): no NEE, march, transmission, textures, environment
map or Russian roulette, and at least one bounce.

The primal standard loop's bounce on BVH hits has a kernel of its own
(``csrc/path_shade.cu``): :func:`path_shade_bvh` shades the hits that
render/traverse.py ``trace_bvh`` returns, by triangle and instance, and
advances the loop's packed carry, one launch a tile and bounce where the
PyTorch body made ~600 (:func:`path_shade_bvh_plain` on CPU tensors).
render/integrator.py ``path_trace`` takes it where
:func:`path_shade_entry` says so, the same on the CPU and the card.
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core.vec import Vec3, where as vwhere
from gdpathtracing_torch.ops.intersect import (LITE_R, OUT_R, TracePrep,
                                               _hit_from_rows, _launch,
                                               _sc_lite_fits, lite_epilogue)
from gdpathtracing_torch.ops.megakernel import sky_constants
from gdpathtracing_torch.render.shading import (get_shading_data,
                                                material_table)
from gdpathtracing_torch.render.sky import sample_sky
from gdpathtracing_torch.render.types import HitInfo, Ray
from gdpathtracing_torch.scene.scene import Scene

NF, NI = 17, 6  # render/regen.py's float and int64 lane rows (no march)


def _kernel_takes(scene: Scene, config: RenderConfig) -> bool:
    """No transmission, textures, environment map or Russian roulette,
    and at least one bounce."""
    return (not (scene.has_transmission or scene.has_textures
                 or scene.has_mr_textures or scene.has_env)
            and config.rr_start == 0 and config.bounces >= 1)


def shade_entry(scene: Scene, config: RenderConfig, prep: TracePrep | None,
                march: bool, use_nee: bool) -> str | None:
    """Regen's shading path for a frame: ``"lite"`` (:func:`regen_shade_lite`)
    where kernel 3 traces, ``"rows"`` (:func:`regen_shade`) for any other
    PALLAS ``prep``, else None (regen's torch body)."""
    if prep is None or march or use_nee or not _kernel_takes(scene, config):
        return None
    return "lite" if _sc_lite_fits(prep) else "rows"


def regen_shade_plain(scene: Scene, rows, fs, ints, active,
                      config: RenderConfig):
    """:func:`regen_shade` in PyTorch: regen's torch body on the hit that
    the winner ``rows`` give."""
    from gdpathtracing_torch.render.regen import _shade_torch

    return _shade_torch(scene, config, _hit_from_rows(rows, active), fs,
                        ints, active)


def regen_shade(scene: Scene, rows: torch.Tensor, fs: torch.Tensor,
                ints: torch.Tensor, active: torch.Tensor,
                config: RenderConfig):
    """Shade one regen iteration of ``n`` lanes: the (48, n) winner
    ``rows`` of their segments (ops/intersect.py layout), the lane stacks
    ``fs`` (NF, n) f32 and ``ints`` (NI, n) int64 (render/regen.py layout;
    each may be the first n columns of a wider stack) and the (n,) bool
    ``active``. Returns (fs, ints, alive, dead_now, counts): the new
    stacks, (n,) bool masks of the lanes that go on and of those that
    ended now, and their two counts.

    CUDA tensors launch the kernel (counted in ``regen_shade.launches``);
    CPU tensors run :func:`regen_shade_plain`. Raises on a scene or config
    the kernel does not take, and on anything else it cannot read."""
    _check(scene, config, active, ("rows", rows, OUT_R), fs, ints)
    if active.device.type == "cpu":
        return regen_shade_plain(scene, rows, fs, ints, active, config)
    out = _outputs(active)
    _launch("regen_shade", (rows, fs, ints, active, *out),
            active.shape[0], rows.stride(0), fs.stride(0), ints.stride(0),
            int(config.bounces),
            floats=(config.ray_eps, *sky_constants(config)),
            wrapper=regen_shade)
    return out


regen_shade.launches = 0


def lite_tables(scene: Scene) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The row-major tables :func:`regen_shade_lite` gathers from, one
    row a lane each: ``isect_cols`` (E, 12) (the scene keeps it
    column-major), ``isect_shade`` (E, 16) and render/shading.py
    ``material_table`` (M, 13). Regen builds them once a frame."""
    scene = scene.detach()
    return (scene.isect_cols.contiguous(), scene.isect_shade.contiguous(),
            material_table(scene))


def regen_shade_lite_plain(scene: Scene, prep: TracePrep, lite, fs, ints,
                           active, config: RenderConfig):
    """:func:`regen_shade_lite` in PyTorch: ops/intersect.py
    ``lite_epilogue`` on kernel 3's winners ``lite`` and the rays of
    ``fs``, then regen's torch body."""
    from gdpathtracing_torch.render.regen import _shade_torch

    ray = Ray(Vec3(*fs[0:3]), Vec3(*fs[3:6]))
    hit = lite_epilogue(scene, prep, ray, active, lite[0],
                        lite[1].to(torch.int32))._replace(
        steps=lite[2].to(torch.int32))
    return _shade_torch(scene, config, hit, fs, ints, active)


def regen_shade_lite(scene: Scene, prep: TracePrep, lite: torch.Tensor,
                     fs: torch.Tensor, ints: torch.Tensor,
                     active: torch.Tensor, config: RenderConfig,
                     tables: tuple):
    """:func:`regen_shade` on the winners of kernel 3: ``lite`` (8, n),
    rows 0 t, 1 eidx, 2 triangles swept (ops/intersect.py
    ``sc_lite_winners``; may be the first n columns of a wider output),
    gathering from the scene's :func:`lite_tables` ``tables``, which the
    caller builds once a frame. ``prep`` is the scene's
    ``prepare_trace_inputs`` (the plain version's ``lite_epilogue`` reads
    it). Returns what :func:`regen_shade` returns.

    CUDA tensors launch the kernel (counted in
    ``regen_shade_lite.launches``); CPU tensors run
    :func:`regen_shade_lite_plain`. Raises on a scene or config the kernel
    does not take, and on anything else it cannot read."""
    _check(scene, config, active, ("lite", lite, LITE_R), fs, ints)
    if len(tables) != 3:
        raise ValueError("tables must be lite_tables(scene)")
    for name, x, w in zip(("isect_cols", "isect_shade", "mats"), tables,
                          (12, 16, 13)):
        if x.dim() != 2 or x.shape[1] != w or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.device != active.device:
            raise ValueError(f"{name} must be contiguous (*, {w}) float32 "
                             f"on {active.device}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    if active.device.type == "cpu":
        return regen_shade_lite_plain(scene, prep, lite, fs, ints, active,
                                      config)
    out = _outputs(active)
    _launch("regen_shade_lite", (lite, *tables, fs, ints, active, *out),
            active.shape[0], lite.stride(0), fs.stride(0), ints.stride(0),
            int(config.bounces),
            floats=(config.ray_eps, *sky_constants(config)),
            source="regen_shade", wrapper=regen_shade_lite)
    return out


regen_shade_lite.launches = 0


def _check(scene: Scene, config: RenderConfig, active, hit, fs,
           ints) -> None:
    """Raise unless the kernels take ``scene`` and ``config``, ``active``
    is a non-empty contiguous bool vector on the CPU or the card, and the
    ``hit`` operand (name, tensor, rows) and the lane stacks are (rows, n)
    with unit column stride on its device: the hit and ``fs`` float32,
    ``ints`` int64."""
    if not _kernel_takes(scene, config):
        raise ValueError("regen's shading kernels take no transmission, "
                         "textures, environment map or Russian roulette, "
                         "and at least one bounce")
    n, dev = active.shape[0], active.device
    if active.dtype != torch.bool or not active.is_contiguous() or n == 0:
        raise ValueError("active must be a contiguous non-empty bool vector")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    for name, x, r, dtype in ((*hit, torch.float32),
                              ("fs", fs, NF, torch.float32),
                              ("ints", ints, NI, torch.int64)):
        if x.dim() != 2 or x.shape != (r, n) or x.dtype != dtype \
                or x.stride(1) != 1 or x.device != dev:
            raise ValueError(f"{name} must be ({r}, {n}) {dtype} with unit "
                             f"column stride on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} strides "
                             f"{x.stride()} on {x.device}")


def _outputs(active):
    """Fresh (NF, n) f32 and (NI, n) int64 stacks, the two (n,) masks and
    the (2,) int32 counts, on ``active``'s device."""
    n, dev = active.shape[0], active.device
    return (torch.empty((NF, n), dtype=torch.float32, device=dev),
            torch.empty((NI, n), dtype=torch.int64, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(2, dtype=torch.int32, device=dev))


# ---- the primal standard loop's bounce on BVH hits ------------------------

_F32, _I32 = torch.float32, torch.int32
# The scene tables path_shade_bvh gathers from, in the order of its C entry
# point, with their dtype and shape (T triangles, I instances, S material
# slots an instance, M materials).
_BVH_TABLES = {"tri_normal": (_F32, ("T", 3, 3)), "tri_slot": (_I32, ("T",)),
               "inst_materials": (_I32, ("I", "S")),
               "inst_transform": (_F32, ("I", 3, 4)),
               "mat_albedo": (_F32, ("M", 3)),
               "mat_emission": (_F32, ("M", 3)),
               "mat_emission_energy": (_F32, ("M",)),
               "mat_metallic": (_F32, ("M",)),
               "mat_roughness": (_F32, ("M",))}


def path_shade_entry(scene: Scene, config: RenderConfig) -> str | None:
    """The standard loop's shading path for a render: ``"bvh"``
    (:func:`path_shade_bvh`, one launch a bounce) for a primal BVH render
    with no NEE, no soft primary and no ray sort, on a scene and config
    the kernel takes (no transmission, textures, environment map or
    Russian roulette, and at least one bounce), else None (the loop's
    torch body). It has no device term: the CPU takes the card's branch
    and runs the plain version."""
    if (config.traversal != Traversal.BVH or config.differentiable
            or (config.nee and scene.n_lights > 0)
            or config.soft_primary > 0.0 or config.sort_rays
            or not _kernel_takes(scene, config)):
        return None
    return "bvh"


def path_shade_bvh_plain(scene: Scene, hit: HitInfo, fs, seeds, counts,
                         active, config: RenderConfig, bounce: int):
    """:func:`path_shade_bvh` in PyTorch: the standard loop's body for
    this case (render/integrator.py), on the rows of the carry."""
    from gdpathtracing_torch.render.integrator import continue_path

    ray_o, ray_d = Vec3(*fs[0:3]), Vec3(*fs[3:6])
    throughput, radiance = Vec3(*fs[6:9]), Vec3(*fs[9:12])
    depth, normal = fs[13], Vec3(*fs[14:17])
    steps, segments = counts
    r = Ray(ray_o, ray_d)
    is_hit = hit.hit & active
    steps = steps + torch.where(active, hit.steps, 0)
    segments = segments + active.to(torch.int32)
    s = get_shading_data(scene, hit, r, fast=False)
    sky = sample_sky(ray_d, config, scene)
    emission = vwhere(is_hit, s.emission, sky)
    radiance = vwhere(active, radiance + throughput * emission, radiance)
    if bounce == 0:  # first-hit AOVs
        depth = torch.where(is_hit, (s.position - ray_o).length(), depth)
        normal = vwhere(is_hit, s.normal, normal)
    new_o, new_dir, new_tp, survive, pdf, seed = continue_path(
        s, hit, r, throughput, is_hit, (seeds[0], seeds[1]), config,
        scene.has_transmission, bounce)
    fs = torch.stack([*vwhere(survive, new_o, ray_o),
                      *vwhere(survive, new_dir, ray_d),
                      *vwhere(survive, new_tp, throughput), *radiance,
                      torch.where(survive, pdf, -1.0), depth, *normal])
    return fs, torch.stack(seed), torch.stack([steps, segments]), survive


def path_shade_bvh(scene: Scene, hit: HitInfo, fs: torch.Tensor,
                   seeds: torch.Tensor, counts: torch.Tensor,
                   active: torch.Tensor, config: RenderConfig, bounce: int):
    """Shade bounce ``bounce`` of the primal standard loop on the hit
    ``trace_bvh`` found for the carry's rays and advance the carry: ``fs``
    (NF, n) f32 (regen's rows: origin, direction, throughput, radiance,
    prev pdf, depth, first-hit normal), ``seeds`` (2, n) int64 (the PCG2D
    words), ``counts`` (2, n) int32 (steps, segments) and ``active`` (n,)
    bool, each contiguous. Returns the new (fs, seeds, counts, active),
    fresh tensors of the same shapes.

    CUDA tensors launch the kernel (counted in ``path_shade_bvh.launches``);
    CPU tensors run :func:`path_shade_bvh_plain`. Raises where
    :func:`path_shade_entry` declines the scene and config, and on
    anything else the kernel cannot read."""
    _check_bvh(scene, config, hit, fs, seeds, counts, active, bounce)
    if active.device.type == "cpu":
        return path_shade_bvh_plain(scene, hit, fs, seeds, counts, active,
                                    config, bounce)
    n, dev = active.shape[0], active.device
    sizes = dict(T=scene.tri_normal.shape[0], I=scene.inst_transform.shape[0],
                 S=scene.inst_materials.shape[1], M=scene.mat_albedo.shape[0])
    tables = []
    for name, (dtype, shape) in _BVH_TABLES.items():
        x = getattr(scene, name).detach()
        want = tuple(sizes.get(k, k) for k in shape)
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != want:
            raise ValueError(f"scene.{name} is {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}; the kernel takes {dtype} {want} "
                             f"on {dev}")
        tables.append(x.contiguous())
    out = (torch.empty_like(fs), torch.empty_like(seeds),
           torch.empty_like(counts), torch.empty_like(active))
    _launch("path_shade_bvh",
            (hit.t, hit.u, hit.v, hit.tri, hit.inst, hit.front, hit.steps,
             *tables, fs, seeds, counts, active, *out),
            n, *sizes.values(), bounce,
            floats=(config.ray_eps, *sky_constants(config)),
            source="path_shade", wrapper=path_shade_bvh)
    return out


path_shade_bvh.launches = 0


def _check_bvh(scene: Scene, config: RenderConfig, hit: HitInfo, fs, seeds,
               counts, active, bounce: int) -> None:
    """Raise unless :func:`path_shade_entry` takes ``scene`` and
    ``config``, ``bounce`` is one of its bounces, and the hit and the carry
    are contiguous tensors of the shapes and dtypes :func:`path_shade_bvh`
    names, on the CPU or the card."""
    if path_shade_entry(scene, config) != "bvh":
        raise ValueError("path_shade_bvh takes a primal BVH render with no "
                         "NEE, soft primary, ray sort, transmission, "
                         "textures, environment map or Russian roulette, "
                         "and at least one bounce")
    if not isinstance(bounce, int) or not 0 <= bounce < config.bounces:
        raise ValueError(f"bounce={bounce!r} must be an int in "
                         f"[0, {config.bounces})")
    n, dev = active.shape[0], active.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if n == 0:
        raise ValueError("path_shade_bvh takes at least one lane")
    if hit.rows is not None:
        raise ValueError("the hit must be trace_bvh's (no winner rows)")
    for name, x, shape, dtype in (
            ("active", active, (n,), torch.bool),
            ("hit.t", hit.t, (n,), _F32), ("hit.u", hit.u, (n,), _F32),
            ("hit.v", hit.v, (n,), _F32), ("hit.tri", hit.tri, (n,), _I32),
            ("hit.inst", hit.inst, (n,), _I32),
            ("hit.front", hit.front, (n,), torch.bool),
            ("hit.steps", hit.steps, (n,), _I32),
            ("fs", fs, (NF, n), _F32), ("seeds", seeds, (2, n), torch.int64),
            ("counts", counts, (2, n), _I32)):
        if tuple(x.shape) != shape or x.dtype != dtype \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on {dev}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
