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

The differentiable standard loop's bounce, where the only gradient wanted
is the albedo's, is one autograd node (:class:`PathShadeDiff`, applied by
:func:`diff_bounce`): :func:`path_shade_diff` shades the hit the recompute
epilogue gave and advances the carry in one launch, saving 40 bytes a lane;
:func:`path_shade_diff_bwd` turns the gradients of the new radiance and
throughput into the old throughput's and ``mat_albedo``'s in one more,
where the body's ~600 ops and their backward graph ran
(:func:`path_shade_diff_plain`, :func:`path_shade_diff_bwd_plain` on CPU
tensors).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core.vec import Vec3, where as vwhere
from gdpathtracing_torch.ops.intersect import (LITE_R, OUT_R, TracePrep,
                                               _hit_from_rows, _launch,
                                               _sc_lite_fits, lite_epilogue)
from gdpathtracing_torch.ops.megakernel import sky_constants
from gdpathtracing_torch.render import brdf
from gdpathtracing_torch.render.shading import material_table
from gdpathtracing_torch.render.types import HitInfo, Ray, ShadingInfo
from gdpathtracing_torch.scene.scene import _TENSOR_FIELDS, Scene

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


def path_shade_entry(scene: Scene, config: RenderConfig,
                     ray: Ray | None = None) -> str | None:
    """The standard loop's shading path for a render of ``ray`` (None: a
    ray that needs no gradient): ``"bvh"`` (:func:`path_shade_bvh`, one
    launch a bounce) for a primal BVH render with no NEE, no soft primary
    and no ray sort; ``"diff"`` (:func:`diff_bounce`, one launch a bounce
    and one in the backward) for a differentiable PALLAS render with no NEE,
    no soft primary and no ``grad_attached``, of at most
    :data:`DIFF_MAX_MATS` materials, where no scene tensor but
    ``mat_albedo`` and neither the ray's origin nor its direction requires
    grad; either on a scene and config the kernels take (no transmission,
    textures, environment map or Russian roulette, and at least one
    bounce); else None (the loop's torch body). It has no device term: the
    CPU takes the card's branch and runs the plain versions."""
    if (config.nee and scene.n_lights > 0) or config.soft_primary > 0.0 \
            or not _kernel_takes(scene, config):
        return None
    if config.traversal == Traversal.BVH and not config.differentiable \
            and not config.sort_rays:
        return "bvh"
    if (config.traversal == Traversal.PALLAS and config.differentiable
            and not config.grad_attached
            and scene.mat_albedo.shape[0] <= DIFF_MAX_MATS
            and not any(getattr(scene, f).requires_grad
                        for f in _TENSOR_FIELDS if f != "mat_albedo")
            and not (ray is not None and any(
                x.requires_grad for x in (*ray.o, *ray.d)))):
        return "diff"
    return None


def path_shade_bvh_plain(scene: Scene, hit: HitInfo, fs, seeds, counts,
                         active, config: RenderConfig, bounce: int):
    """:func:`path_shade_bvh` in PyTorch: the standard loop's body for
    this case (render/integrator.py ``shade_bounce``), on the rows of the
    carry."""
    from gdpathtracing_torch.render.integrator import shade_bounce

    out = shade_bounce(scene, hit, Ray(Vec3(*fs[0:3]), Vec3(*fs[3:6])),
                       Vec3(*fs[6:9]), Vec3(*fs[9:12]), active,
                       (seeds[0], seeds[1]), fs[13], counts[0], counts[1],
                       Vec3(*fs[14:17]), config, bounce)[0]
    fs = torch.stack([*out.ray_o, *out.ray_d, *out.throughput,
                      *out.radiance, out.prev_pdf, out.depth, *out.normal])
    return (fs, torch.stack(out.seed), torch.stack([out.steps, out.segments]),
            out.active)


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


# ---- the differentiable standard loop's bounce ------------------------------

# The most materials the backward kernel sums in a block's shared memory
# (M rows of 3 floats, 12 KB).
DIFF_MAX_MATS = 1024


class Bounce(NamedTuple):
    """What one bounce of the standard loop leaves: the fields of
    render/integrator.py's carry, in its order, up to the first-hit
    normal."""
    ray_o: Vec3
    ray_d: Vec3
    throughput: Vec3
    radiance: Vec3
    active: torch.Tensor     # survive
    seed: tuple
    depth: torch.Tensor
    steps: torch.Tensor
    segments: torch.Tensor
    prev_pdf: torch.Tensor
    normal: Vec3


def diff_tables(scene: Scene) -> tuple[torch.Tensor, torch.Tensor]:
    """The detached, contiguous tables :func:`path_shade_diff` gathers
    from: ``isect_shade`` (E, 16) and render/shading.py ``material_table``
    (M, 13). The loop builds them once a call."""
    scene = scene.detach()
    return scene.isect_shade.contiguous(), material_table(scene)


def albedo_slope(s: ShadingInfo, light_dir: Vec3, metallic) -> torch.Tensor:
    """d f_c / d albedo_c of render/brdf.py ``eval_brdf`` at ``light_dir``:
    one value for the three channels, since ``diffuse_albedo`` (albedo -
    albedo * metallic) and ``fresnel_0`` (0.02 + (albedo - 0.02) *
    metallic) are affine in the albedo, ((1 - metallic) * fd + metallic *
    (1 - fac5) * D * G) / pi, 0 where eval_brdf is 0 (csrc/path_shade.cu
    ``albedo_slope``)."""
    valid, fd, dg, fac5 = brdf.brdf_terms(s, light_dir)
    slope = ((1.0 - metallic) * fd + metallic * (1.0 - fac5) * dg) \
        * (1.0 / brdf.PI)
    return torch.where(valid, slope, 0.0)


def path_shade_diff_plain(scene: Scene, hit: HitInfo, ray: Ray,
                          throughput: Vec3, radiance: Vec3, active, seed,
                          depth, steps, segments, normal: Vec3,
                          config: RenderConfig, bounce: int, save: bool):
    """:func:`path_shade_diff` in PyTorch: the differentiable loop's body
    for this case (render/integrator.py ``shade_bounce``), under no_grad,
    and with ``save`` what its backward reads."""
    from gdpathtracing_torch.render.integrator import shade_bounce

    with torch.no_grad():
        scene = scene.detach()
        out, s, is_hit, emission = shade_bounce(
            scene, hit, ray, throughput, radiance, active, seed, depth, steps,
            segments, normal, config, bounce)
        if not save:
            return out, None
        # continue_path's throughput factor and the albedo's slope of it,
        # where the path goes on (its sampled direction and pdf).
        survive, new_dir, pdf = out.active, out.ray_d, out.prev_pdf
        lambert_in = s.normal.dot(new_dir)
        scale = torch.where(pdf > 1e-12,
                            lambert_in / torch.clamp(pdf, min=1e-12), 0.0)
        mult = brdf.eval_brdf(s, new_dir) * scale
        mat = torch.where(is_hit, scene.isect_shade[
            torch.clamp(hit.eidx, min=0).long(), 15].to(torch.int64), 0)
        k = torch.where(survive, albedo_slope(
            s, new_dir, scene.mat_metallic[mat]) * scale, 0.0)
        zero = torch.zeros_like(scale)
        saved = torch.stack([
            *vwhere(active, emission, Vec3(zero, zero, zero)),
            *vwhere(survive, mult, Vec3.full(1.0, like=mult)),
            k * throughput.x, k * throughput.y, k * throughput.z])
        return out, (saved, mat.to(torch.int32))


_DIFF_OUTPUTS = 11  # the kernel's fs rows: origin, direction, prev pdf,
#                     depth, first-hit normal


def path_shade_diff(scene: Scene, tables: tuple, hit: HitInfo, ray: Ray,
                    throughput: Vec3, radiance: Vec3, active, seed, depth,
                    steps, segments, normal: Vec3, config: RenderConfig,
                    bounce: int, save: bool):
    """Shade bounce ``bounce`` of the differentiable standard loop on the
    hit ``_diff_epilogue`` recomputed for the carry's ``ray`` and advance
    the carry (``throughput``, ``radiance``, ``normal``: Vec3 of (n,) f32;
    ``active`` (n,) bool; ``seed`` two (n,) int64 PCG2D words; ``depth``
    (n,) f32; ``steps``, ``segments`` (n,) int32), gathering from the
    scene's :func:`diff_tables` ``tables``. Returns (:class:`Bounce`,
    saved): the new carry in fresh tensors (past bounce 0 ``depth`` and
    ``normal`` are the ones given), and with ``save`` what
    :func:`path_shade_diff_bwd` reads, ((9, n) f32, (n,) int32), else None.
    Takes no gradient itself: :func:`diff_bounce` differentiates it.

    CUDA tensors launch the kernel (counted in
    ``path_shade_diff.launches``); CPU tensors run
    :func:`path_shade_diff_plain`. Raises where :func:`path_shade_entry`
    declines the config, and on anything else the kernel cannot read."""
    carry = (*ray.o, *ray.d, *throughput, *radiance, active, *seed, depth,
             steps, segments, *normal)
    _check_diff(scene, config, tables, hit, carry, bounce)
    if active.device.type == "cpu":
        return path_shade_diff_plain(scene, hit, ray, throughput, radiance,
                                     active, seed, depth, steps, segments,
                                     normal, config, bounce, save)
    n, dev = active.shape[0], active.device
    shade_rows, mats = tables
    fs = torch.empty((_DIFF_OUTPUTS, n), dtype=_F32, device=dev)
    tp = [torch.empty(n, dtype=_F32, device=dev) for _ in range(3)]
    rad = [torch.empty(n, dtype=_F32, device=dev) for _ in range(3)]
    seeds = torch.empty((2, n), dtype=torch.int64, device=dev)
    counts = torch.empty((2, n), dtype=_I32, device=dev)
    survive = torch.empty(n, dtype=torch.bool, device=dev)
    # Without save the kernel writes no saved rows: any two pointers do.
    saved = (torch.empty((9, n), dtype=_F32, device=dev),
             torch.empty(n, dtype=_I32, device=dev)) if save else (fs, counts)
    _launch("path_shade_diff",
            (hit.t, hit.u, hit.v, hit.front, hit.eidx, hit.steps, shade_rows,
             mats, *(x.contiguous() for x in carry), fs, *tp, *rad, seeds,
             counts, survive, *saved),
            n, shade_rows.shape[0], mats.shape[0], bounce, int(save),
            floats=(config.ray_eps, *sky_constants(config)),
            source="path_shade", wrapper=path_shade_diff)
    if bounce == 0:
        depth, normal = fs[7], Vec3(*fs[8:11])
    out = Bounce(Vec3(*fs[0:3]), Vec3(*fs[3:6]), Vec3(*tp), Vec3(*rad),
                     survive, (seeds[0], seeds[1]), depth, counts[0],
                     counts[1], fs[6], normal)
    return out, saved if save else None


path_shade_diff.launches = 0


def path_shade_diff_bwd_plain(saved: torch.Tensor, mat: torch.Tensor,
                              g_rad: tuple, g_tp: tuple, n_mats: int):
    """:func:`path_shade_diff_bwd` in PyTorch."""
    g_tp_in = torch.stack([saved[c] * g_rad[c] + g_tp[c] * saved[3 + c]
                           for c in range(3)])
    add = torch.stack([g_tp[c] * saved[6 + c] for c in range(3)], dim=1)
    g_albedo = torch.zeros((n_mats, 3), dtype=_F32, device=saved.device)
    return g_tp_in, g_albedo.index_add_(0, mat.to(torch.int64), add)


def path_shade_diff_bwd(saved: torch.Tensor, mat: torch.Tensor,
                        g_rad: tuple, g_tp: tuple, n_mats: int):
    """The backward of :func:`path_shade_diff` from what it saved
    (``saved`` (9, n) f32, ``mat`` (n,) int32) and the gradients of the new
    radiance and throughput (``g_rad``, ``g_tp``: three (n,) f32 each):
    (the throughput's gradient (3, n), ``mat_albedo``'s (n_mats, 3)). The
    radiance's gradient passes through unchanged and is not computed here.

    CUDA tensors launch the kernel (counted in
    ``path_shade_diff_bwd.launches``; the sum into the albedo rows is
    atomic, so its order varies from run to run); CPU tensors run
    :func:`path_shade_diff_bwd_plain`. Raises on what the kernel cannot
    read."""
    n, dev = mat.shape[0], mat.device
    if not 0 < n_mats <= DIFF_MAX_MATS:
        raise ValueError(f"n_mats={n_mats} must be in [1, {DIFF_MAX_MATS}]")
    for name, x, shape, dtype in (
            ("saved", saved, (9, n), _F32), ("mat", mat, (n,), _I32),
            *((f"g_rad[{c}]", g, (n,), _F32) for c, g in enumerate(g_rad)),
            *((f"g_tp[{c}]", g, (n,), _F32) for c, g in enumerate(g_tp))):
        if tuple(x.shape) != shape or x.dtype != dtype \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on {dev}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    if n == 0 or len(g_rad) != 3 or len(g_tp) != 3:
        raise ValueError("path_shade_diff_bwd takes at least one lane and "
                         "three gradient components of each")
    if dev.type == "cpu":
        return path_shade_diff_bwd_plain(saved, mat, g_rad, g_tp, n_mats)
    g_tp_in = torch.empty((3, n), dtype=_F32, device=dev)
    g_albedo = torch.empty((n_mats, 3), dtype=_F32, device=dev)
    _launch("path_shade_diff_bwd", (saved, mat, *g_rad, *g_tp, g_tp_in,
                                    g_albedo),
            n, n_mats, source="path_shade", wrapper=path_shade_diff_bwd)
    return g_tp_in, g_albedo


path_shade_diff_bwd.launches = 0


def _flat(b: Bounce) -> tuple:
    """The 22 tensors of a bounce's carry, in order."""
    return (*b.ray_o, *b.ray_d, *b.throughput, *b.radiance, b.active,
            *b.seed, b.depth, b.steps, b.segments, b.prev_pdf, *b.normal)


def _unflat(x) -> Bounce:
    return Bounce(Vec3(*x[0:3]), Vec3(*x[3:6]), Vec3(*x[6:9]),
                  Vec3(*x[9:12]), x[12], (x[13], x[14]), x[15], x[16], x[17],
                  x[18], Vec3(*x[19:22]))


class PathShadeDiff(torch.autograd.Function):
    """One bounce of the differentiable loop as one autograd node: the
    forward is :func:`path_shade_diff`, the backward
    :func:`path_shade_diff_bwd`. Its inputs are ``mat_albedo``, the scene,
    its :func:`diff_tables`, the hit, the config, the bounce and the
    carry's 21 tensors in :func:`path_shade_diff`'s order (ray origin and
    direction, throughput, radiance, active, seed, depth, steps, segments,
    first-hit normal); its outputs the new carry's 22 (:class:`Bounce`).
    Gradients flow from the new throughput and radiance to ``mat_albedo``
    and the old throughput and radiance alone. Its backward is not
    differentiated again."""

    @staticmethod
    def forward(ctx, albedo, scene, tables, hit, config, bounce, *carry):
        c = carry
        out, saved = path_shade_diff(
            scene, tables, hit, Ray(Vec3(*c[0:3]), Vec3(*c[3:6])),
            Vec3(*c[6:9]), Vec3(*c[9:12]), c[12], (c[13], c[14]), c[15],
            c[16], c[17], Vec3(*c[18:21]), config, bounce, True)
        ctx.save_for_backward(*saved)
        ctx.n_mats = albedo.shape[0]
        ctx.set_materialize_grads(False)
        flat = _flat(out)
        ctx.mark_non_differentiable(*flat[:6], *flat[12:])
        return flat

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        saved, mat = ctx.saved_tensors
        g_tp, g_rad = (tuple(torch.zeros_like(saved[0]) if g is None
                             else g.contiguous() for g in gs)
                       for gs in (grads[6:9], grads[9:12]))
        g_tp_in, g_albedo = path_shade_diff_bwd(saved, mat, g_rad, g_tp,
                                                ctx.n_mats)
        return (g_albedo, None, None, None, None, None, *(None,) * 6,
                *g_tp_in, *grads[9:12], *(None,) * 9)


def diff_bounce(scene: Scene, tables: tuple, hit: HitInfo, ray: Ray,
                throughput: Vec3, radiance: Vec3, active, seed, depth, steps,
                segments, normal: Vec3, config: RenderConfig,
                bounce: int) -> Bounce:
    """One bounce of the differentiable loop where :func:`path_shade_entry`
    says ``"diff"``: :func:`path_shade_diff` on the carry, through
    :class:`PathShadeDiff` where a gradient may reach ``scene.mat_albedo``,
    the throughput or the radiance (else nothing is saved for a backward).
    Returns the new carry."""
    if not (torch.is_grad_enabled() and any(
            x.requires_grad
            for x in (scene.mat_albedo, *throughput, *radiance))):
        return path_shade_diff(scene, tables, hit, ray, throughput, radiance,
                               active, seed, depth, steps, segments, normal,
                               config, bounce, False)[0]
    return _unflat(PathShadeDiff.apply(
        scene.mat_albedo, scene, tables, hit, config, bounce, *ray.o, *ray.d,
        *throughput, *radiance, active, *seed, depth, steps, segments,
        *normal))


def _check_diff(scene: Scene, config: RenderConfig, tables, hit: HitInfo,
                carry: tuple, bounce: int) -> None:
    """Raise unless :func:`path_shade_entry` takes ``config`` for the
    differentiable loop, ``bounce`` is one of its bounces, ``tables`` are
    :func:`diff_tables`, and the hit and the carry's (n,) tensors are of
    the dtypes :func:`path_shade_diff` names, on the CPU or the card, with
    the hit contiguous and needing no gradient."""
    if path_shade_entry(scene, config) != "diff":
        raise ValueError("path_shade_diff takes a differentiable PALLAS "
                         "render with no NEE, soft primary, grad_attached, "
                         "transmission, textures, environment map or "
                         "Russian roulette, at least one bounce, at most "
                         f"{DIFF_MAX_MATS} materials and no scene tensor "
                         "but mat_albedo that requires grad")
    if not isinstance(bounce, int) or not 0 <= bounce < config.bounces:
        raise ValueError(f"bounce={bounce!r} must be an int in "
                         f"[0, {config.bounces})")
    active = carry[12]
    n, dev = active.shape[0], active.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if n == 0:
        raise ValueError("path_shade_diff takes at least one lane")
    if hit.rows is not None:
        raise ValueError("the hit must be _diff_epilogue's (no winner rows)")
    for name, x, w, dtype in (
            ("shade table", tables[0], 16, _F32),
            ("material table", tables[1], 13, _F32)):
        if x.dim() != 2 or x.shape[1] != w or x.dtype != dtype \
                or not x.is_contiguous() or x.device != dev \
                or x.requires_grad:
            raise ValueError(f"the {name} must be a detached contiguous "
                             f"(*, {w}) {dtype} tensor on {dev} "
                             f"(diff_tables), got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    hits = (("hit.t", hit.t, _F32), ("hit.u", hit.u, _F32),
            ("hit.v", hit.v, _F32), ("hit.front", hit.front, torch.bool),
            ("hit.eidx", hit.eidx, _I32), ("hit.steps", hit.steps, _I32))
    dtypes = (_F32,) * 12 + (torch.bool, torch.int64, torch.int64, _F32,
                             _I32, _I32) + (_F32,) * 3
    for name, x, dtype in (*hits, *(("carry", x, d)
                                    for x, d in zip(carry, dtypes))):
        if tuple(x.shape) != (n,) or x.dtype != dtype or x.device != dev \
                or (name.startswith("hit") and (not x.is_contiguous()
                                                or x.requires_grad)):
            raise ValueError(f"{name} must be a ({n},) {dtype} tensor on "
                             f"{dev}, got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
