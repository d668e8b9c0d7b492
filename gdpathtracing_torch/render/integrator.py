"""The path-tracing integrator: bounce loop over a ray wavefront.

Port of the standard loop of gdpathtracing_tpu/render/integrator.py, with
the reference's traversals (``get_trace_fn``): ``Traversal.PALLAS``
(ops/intersect.py ``trace_pallas``), ``Traversal.BVH`` (render/traverse.py
``trace_bvh`` with ``config.max_stack``) and the plain oracles
``Traversal.BRUTE`` and ``Traversal.UNIT`` (render/intersect.py
``trace_brute``, ``trace_unit``). ``lax.fori_loop`` becomes a Python loop
over bounces, and the reference's reorderings are kept: on large PALLAS
scenes a per-bounce stable sort of the wavefront by the Morton cell of the
ray origin and the octant of its direction (or wherever ``sort_rays=True``
asks for it), otherwise, on PALLAS, group-granular survivor compaction,
each with the final unsort. Light transport is the reference's: BRDF
importance sampling, ``radiance += throughput * emission`` per segment, sky
on a miss, a hard bounce cap and a ray-origin offset along the shading
normal. With ``config.nee`` each hit also samples an emitter (next-event
estimation) and the two strategies are weighted by the power heuristic
(MIS). On a scene with transmission a dielectric delta lobe is picked with
probability ``transmission`` (Fresnel picks reflection or refraction), and
with ``rr_start > 0`` Russian roulette ends paths from that bounce on; each
draws its random numbers only when on, so neither moves another stream.

With BVH, BRUTE and UNIT, as in the reference, NEE's shadow query is a
closest hit of its own, visible where nothing is hit before the light
(``t < dist·(1 - 1e-3)`` fails); BVH and BRUTE shade a hit by triangle and
instance (render/shading.py's gather path), UNIT and PALLAS by the
expanded-triangle index. With ``soft_shadows``, BRUTE and UNIT take
``occlusion_soft`` and PALLAS kernel 5; BVH keeps its hard query.

On a flat PALLAS scene NEE runs the reference's fused form: bounce i's
shadow query only gates an additive radiance term, so it is resolved by
bounce i+1's closest-hit launch (ops/intersect.py
``trace_occlude_pallas``, kernel 4), and one trailing any-hit launch
(``occluded_pallas``, kernel 2) resolves the last bounce's. The radiance accumulates in the same order as
resolving each query at once would (emission_i, direct_i, emission_i+1,
...). On a superchunk scene, as in the reference, each bounce's shadow
rays are resolved at once by their own any-hit launch.

With ``config.differentiable`` the loop runs the same transport as the
reference's differentiable one: the kernels find hits on detached inputs,
the hit records are recomputed from the live scene (BRUTE and UNIT are
plain torch, differentiated as they run), sampling decisions are detached
(unless ``grad_attached``), and autograd differentiates the rest; each
bounce may run under ``torch.utils.checkpoint`` (``bwd_checkpoint``).
``soft_shadows`` and ``soft_primary`` add the reference's differentiable
silhouette relaxations.

A primal BVH render that ops/shade.py ``path_shade_entry`` takes (no NEE,
soft primary, ray sort, transmission, textures, environment map or Russian
roulette) runs a loop of its own: the carry packed in a few stacks, and
each bounce ``trace_bvh`` and then one ``path_shade_bvh`` (csrc/path_shade.cu
on the card, the torch body's statements on the CPU). A differentiable
PALLAS render that it takes (no NEE, soft primary, ``grad_attached``,
transmission, textures, environment map or Russian roulette, and no
gradient wanted but the albedo's) shades each bounce with one
``diff_bounce`` in place of the body's torch statements: csrc/path_shade.cu's
forward kernel, and its backward kernel, as one autograd node.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.checkpoint

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3, reflect, where as vwhere
from gdpathtracing_torch.ops.fused import fused_supported, path_trace_fused
from gdpathtracing_torch.ops.intersect import (TracePrep, occluded_pallas,
                                               prepare_trace_inputs,
                                               soft_occluded_pallas,
                                               trace_occlude_pallas,
                                               trace_occlude_pallas_diff,
                                               trace_pallas,
                                               trace_pallas_diff)
from gdpathtracing_torch.ops.megakernel import mega_supported, path_trace_mega
from gdpathtracing_torch.ops.shade import (NF, Bounce, diff_bounce,
                                           diff_tables, path_shade_bvh,
                                           path_shade_entry)
from gdpathtracing_torch.render import brdf, lights
from gdpathtracing_torch.render.intersect import (occlusion_soft,
                                                  trace_brute, trace_unit)
from gdpathtracing_torch.render.shading import get_shading_data
from gdpathtracing_torch.render.sky import sample_sky
from gdpathtracing_torch.render.traverse import trace_bvh
from gdpathtracing_torch.render.types import HitInfo, Ray, ShadingInfo
from gdpathtracing_torch.scene.scene import Scene
from gdpathtracing_torch.utils.telemetry import SPANS


def check_path_kernel(scene: Scene, config: RenderConfig) -> None:
    """Raise ValueError where ``Traversal.MEGA`` or ``Traversal.FUSED``
    cannot render: outside the reference's gates (its texts), or with
    ``differentiable=True``, where the reference renders through the kernel
    with no gradient reaching the scene (neither kernel has a VJP) and the
    port refuses rather than return an image whose graph is cut."""
    name = config.traversal.name
    if config.differentiable:
        raise ValueError(
            f"{name} traversal has no gradient (its kernel is not "
            f"differentiated); use PALLAS with differentiable=True")
    if config.traversal == Traversal.FUSED and not fused_supported(scene,
                                                                   config):
        raise ValueError(
            "FUSED traversal unsupported for this scene/config "
            "(textures/env/NEE/transmission or too many triangles); "
            "use PALLAS")
    if config.traversal == Traversal.MEGA and not mega_supported(scene,
                                                                 config):
        raise ValueError(
            "MEGA traversal unsupported for this scene/config "
            "(textures/env/transmission/soft_shadows, >16 chunks, or "
            ">4096 lights); use PALLAS")


def check_supported(scene: Scene, config: RenderConfig) -> None:
    """Raise where the frame loops cannot render ``config``: the path
    kernels (MEGA, FUSED) outside their gates (:func:`check_path_kernel`),
    and a differentiable BVH render."""
    if config.traversal in (Traversal.MEGA, Traversal.FUSED):
        check_path_kernel(scene, config)
        return
    if config.traversal == Traversal.BVH and config.differentiable:
        raise ValueError(
            "BVH traversal has no gradient in this port (its kernel is not "
            "differentiated); the reference renders it, but a gradient that "
            "reaches the geometry or the camera through trace_bvh's "
            "lax.while_loop raises there (reverse-mode differentiation does "
            "not work for lax.while_loop), and only material gradients "
            "pass; use PALLAS with differentiable=True")


def get_trace_fn(config: RenderConfig):
    """The closest-hit traversal of ``config`` as ``trace(scene, ray,
    active, prep)``: ``trace_pallas`` (``trace_pallas_diff`` when
    differentiable), ``trace_bvh``, ``trace_brute`` or ``trace_unit``, as
    the reference's ``get_trace_fn`` picks them. ``prep`` is PALLAS's
    :func:`prepare_trace_inputs`; the others ignore it."""
    t = config.traversal
    if t == Traversal.PALLAS:
        return trace_pallas_diff if config.differentiable else trace_pallas
    if t == Traversal.BVH:
        return lambda scene, ray, active, prep: trace_bvh(
            scene, ray, active, max_stack=config.max_stack)
    if t == Traversal.BRUTE:
        return lambda scene, ray, active, prep: trace_brute(scene, ray,
                                                            active)
    if t == Traversal.UNIT:
        return lambda scene, ray, active, prep: trace_unit(scene, ray,
                                                           active)
    raise ValueError(f"{t} has no closest-hit traversal of its own")


def hit_visibility(trace, scene: Scene, prep):
    """NEE visibility through a closest-hit traversal ``trace`` (BVH,
    BRUTE, UNIT): ``visibility(shadow ray, tmax, active)``, 1 where nothing
    is hit before ``tmax``."""
    def visibility(shadow, tmax, active):
        with SPANS.path_trace:
            return (~(trace(scene, shadow, active, prep).t < tmax)).to(
                torch.float32)
    return visibility


def continue_path(s: ShadingInfo, hit: HitInfo, r: Ray, throughput: Vec3,
                  is_hit, seed, config: RenderConfig, has_transmission: bool,
                  bounce):
    """The next segment of each path: the BRDF sample (one PCG2D draw),
    on a scene with transmission the dielectric delta lobe (one more), and
    with ``rr_start > 0`` Russian roulette (one more) from ``bounce`` (an
    int or a per-lane tensor) on, in the reference's draw order. Returns
    (origin, direction, throughput, survive, prev_pdf value, seed): the
    caller keeps its own state where ``survive`` is false. The sampled
    direction and pdf are detached unless ``grad_attached``, the survival
    probability always (regen, primal only, leaves it attached in the
    reference, which changes no value)."""
    sampled = _sampled(config)
    (r1, r2), seed = rng.pcg2d(seed)
    new_dir = sampled(brdf.sample_brdf(s, r1, r2))
    pdf = sampled(brdf.brdf_pdf(s, new_dir))
    lambert_in = s.normal.dot(new_dir)
    f = brdf.eval_brdf(s, new_dir)
    scale = torch.where(pdf > 1e-12,
                        lambert_in / torch.clamp(pdf, min=1e-12), 0.0)
    mult = f * scale
    survive = is_hit & (lambert_in > 0.0) & (pdf > 1e-12)
    offset = s.normal * config.ray_eps
    prev_pdf = pdf
    if has_transmission:
        # The dielectric delta lobe, picked with probability
        # `transmission`: Fresnel picks reflection or refraction, the
        # albedo tints, a refracted ray leaves from the other side.
        (r3, r4), seed = rng.pcg2d(seed)
        pick_t = r3 < s.transmission
        eta = torch.where(hit.front, 1.0 / s.ior, s.ior)
        fres = brdf.fresnel_dielectric(s.lambert_out, eta)
        refr_dir, tir = brdf.refract(r.d, s.normal, eta)
        do_reflect = (r4 < fres) | tir
        delta_dir = vwhere(do_reflect, reflect(r.d, s.normal), refr_dir)
        new_dir = vwhere(pick_t, delta_dir, new_dir)
        mult = vwhere(pick_t, s.albedo, mult)
        survive = torch.where(pick_t, is_hit, survive)
        offset = vwhere(pick_t & ~do_reflect, -offset, offset)
        prev_pdf = torch.where(pick_t, -1.0, prev_pdf)
    new_tp = throughput * mult
    if config.rr_start > 0:
        # Russian roulette: from bounce rr_start on a path continues with
        # probability p, the next throughput's largest component clamped,
        # and is weighted by 1/p.
        (r5, _), seed = rng.pcg2d(seed)
        p = torch.clamp(torch.maximum(new_tp.x, torch.maximum(new_tp.y,
                                                               new_tp.z)),
                        config.rr_min_p, 1.0).detach()
        do_rr = torch.as_tensor(bounce >= config.rr_start,
                                device=p.device)
        survive = survive & torch.where(do_rr, r5 < p, True)
        new_tp = new_tp * torch.where(do_rr, 1.0 / p, 1.0)
    return s.position + offset, new_dir, new_tp, survive, prev_pdf, seed


def morton_frame(scene: Scene) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, span) of the scene's chunk boxes: the frame of the 8^3 Morton
    cells that the ray sort keys on."""
    cb = scene.isect_chunk_bounds
    lo = cb[0:3].amin(dim=1)
    return lo, torch.clamp(cb[3:6].amax(dim=1) - lo, min=1e-6)


def morton_octant_key(o: Vec3, d: Vec3, lo, span) -> torch.Tensor:
    """(N,) int64 sort key Morton(origin cell, 8^3) * 8 + octant(direction):
    rays of one block then share both an origin region and a direction
    cone, which is what the per-block slab culling needs."""
    def q3(x, k):
        return torch.clamp((x - lo[k]) / span[k] * 8.0, 0.0,
                           7.0).to(torch.int64)
    qx, qy, qz = q3(o.x, 0), q3(o.y, 1), q3(o.z, 2)
    cell = torch.zeros_like(qx)
    for b in range(3):  # 9-bit Morton interleave of 3-bit cells
        cell = cell | (((qx >> b) & 1) << (3 * b + 2)) \
            | (((qy >> b) & 1) << (3 * b + 1)) \
            | (((qz >> b) & 1) << (3 * b))
    octant = ((d.x > 0.0).to(torch.int64) * 4
              + (d.y > 0.0).to(torch.int64) * 2
              + (d.z > 0.0).to(torch.int64))
    return cell * 8 + octant


class PathTraceResult(NamedTuple):
    radiance: Vec3           # (N,) per ray
    depth: torch.Tensor      # (N,) first-hit distance (far on a miss)
    steps: torch.Tensor      # (N,) triangle tests
    segments: torch.Tensor   # (N,) ray segments traced (≤ bounces), shadow
    #                          rays included
    normal: Vec3             # (N,) first-hit shading normal (0 on a miss)


def _compaction_group(n: int) -> int | None:
    return next((g for g in (128, 32, 8) if n % g == 0), None)


def mis_emission(scene: Scene, table: lights.LightTable, hit: HitInfo,
                 ray_d: Vec3, emission: Vec3, is_hit, prev_pdf) -> Vec3:
    """Emission picked up by a BRDF-sampled ray, weighted against NEE by
    the power heuristic. Camera rays and the sky keep weight 1
    (``prev_pdf`` < 0 marks a segment that was not a BRDF sample). The
    light pdf comes from the winner rows where the kernel wrote them,
    else from the light ``table``."""
    if hit.rows is not None:
        pl = lights.light_pdf_from_rows(hit.rows, ray_d, hit.t)
    else:
        pl = lights.light_pdf_of_hit(table, scene, hit.inst, hit.tri, ray_d,
                                     hit.t)
    pb = torch.clamp(prev_pdf, min=0.0)
    w_mis = torch.where(
        (prev_pdf > 0.0) & is_hit & (pl > 0.0),
        (pb * pb) / torch.clamp(pb * pb + pl * pl, min=1e-20), 1.0)
    return emission * w_mis


class DirectLight(NamedTuple):
    """One NEE sample: the shadow query and the contribution it gates."""
    shadow: Ray
    tmax: torch.Tensor    # the query is (0, tmax)
    active: torch.Tensor  # lanes that posted a query
    direct: Vec3          # the contribution if the light is visible


def _sampled(config: RenderConfig):
    """What a sampling decision (a direction, a pdf; a tensor or a Vec3)
    goes through: detached unless ``config.grad_attached`` asks for the
    exact chain rule of the primal estimator (the reference's
    ``stop_gradient``; no effect on values)."""
    if config.grad_attached:
        return lambda x: x
    return lambda x: x.detach()


def sample_direct(s: ShadingInfo, throughput: Vec3, is_hit, seed,
                  table: lights.LightTable, config: RenderConfig,
                  visibility=None):
    """Sample an emitter from each hit (two PCG2D draws) and return
    (DirectLight, new seed): the shadow ray and the MIS-weighted direct
    contribution. Without ``visibility`` it counts only where the caller
    finds the shadow ray unoccluded; ``visibility(shadow ray, tmax,
    active)`` (soft shadows) gives a factor in [0, 1] folded in here, where
    the reference folds it."""
    (lr1, lr2), seed = rng.pcg2d(seed)
    (lr3, _), seed = rng.pcg2d(seed)
    ls = lights.sample_light(table, s.position, lr3, lr1, lr2)
    cos_i = s.normal.dot(ls.wi)
    shadow = Ray(s.position + s.normal * config.ray_eps, ls.wi)
    tmax = ls.dist * (1.0 - 1e-3)
    shadow_active = is_hit & (cos_i > 0.0) & torch.isfinite(ls.pdf_solid)
    vis = None if visibility is None else visibility(shadow, tmax,
                                                     shadow_active)
    f_l = brdf.eval_brdf(s, ls.wi)
    sg = _sampled(config)
    pb_l = sg(brdf.brdf_pdf(s, ls.wi))
    pl_l = sg(ls.pdf_solid)
    # Sanitise the inf of a grazing light sample before any arithmetic
    # (inf/inf is NaN, which the backward pass would carry into cos_i), and
    # the pdf of every lane that posts no query: on a lane that missed, the
    # light is ~1e9 away and pl_safe² overflows. The reference sanitises
    # only the first, so its geometry gradients are NaN once a lane misses
    # with NEE on; selected lanes keep their values.
    pl_ok = torch.isfinite(pl_l) & (pl_l > 1e-12)
    pl_safe = torch.where(pl_ok & shadow_active, pl_l, 1.0)
    w_l = (pl_safe * pl_safe) / torch.clamp(pl_safe * pl_safe + pb_l * pb_l,
                                            min=1e-20)
    scale_l = torch.where(shadow_active & pl_ok, cos_i * w_l / pl_safe, 0.0)
    if vis is not None:
        scale_l = scale_l * vis
    direct = throughput * f_l * ls.emission * scale_l
    return DirectLight(shadow, tmax, shadow_active, direct), seed


class _Carry(NamedTuple):
    """The per-lane state one bounce reads and writes."""
    ray_o: Vec3
    ray_d: Vec3
    throughput: Vec3
    radiance: Vec3
    active: torch.Tensor
    seed: tuple
    depth: torch.Tensor
    steps: torch.Tensor
    segments: torch.Tensor
    prev_pdf: torch.Tensor
    normal: Vec3
    src: torch.Tensor | None  # each lane's source slot (reordering only)
    pend: DirectLight         # the pending shadow query (fused NEE)


def shade_hit(scene: Scene, hit: HitInfo, r: Ray, active, steps, segments,
              config: RenderConfig):
    """The start of a bounce's shading: (the lanes that hit, the steps and
    segments counted, the hit's shading, the sky along ``r``). PALLAS and
    UNIT hits are shaded from their expanded-triangle index, others by
    triangle and instance."""
    is_hit = hit.hit & active
    steps = steps + torch.where(active, hit.steps, 0)
    segments = segments + active.to(torch.int32)
    s = get_shading_data(scene, hit, r, fast=config.traversal in (
        Traversal.PALLAS, Traversal.UNIT))
    return is_hit, steps, segments, s, sample_sky(r.d, config, scene)


def next_bounce(s: ShadingInfo, hit: HitInfo, r: Ray, throughput: Vec3,
                radiance: Vec3, is_hit, seed, depth, steps, segments,
                normal: Vec3, config: RenderConfig, has_transmission: bool,
                i: int) -> Bounce:
    """The end of bounce ``i``'s shading: the first-hit AOVs at bounce 0,
    then :func:`continue_path`; each lane whose path ends keeps its ray
    and throughput."""
    if i == 0:  # first-hit AOVs
        depth = torch.where(is_hit, (s.position - r.o).length(), depth)
        normal = vwhere(is_hit, s.normal, normal)
    new_o, new_dir, new_tp, survive, pdf, seed = continue_path(
        s, hit, r, throughput, is_hit, seed, config, has_transmission, i)
    return Bounce(vwhere(survive, new_o, r.o), vwhere(survive, new_dir, r.d),
                  vwhere(survive, new_tp, throughput), radiance, survive,
                  seed, depth, steps, segments,
                  torch.where(survive, pdf, -1.0), normal)


def shade_bounce(scene: Scene, hit: HitInfo, r: Ray, throughput: Vec3,
                 radiance: Vec3, active, seed, depth, steps, segments,
                 normal: Vec3, config: RenderConfig, i: int):
    """Bounce ``i``'s shading with no NEE and no soft primary: the loop
    body's statements for that case, the plain versions of ops/shade.py's
    shading kernels. Returns (the new carry, the shading, the lanes that
    hit, the emission or sky each lane adds where active)."""
    is_hit, steps, segments, s, sky = shade_hit(scene, hit, r, active, steps,
                                                segments, config)
    emission = vwhere(is_hit, s.emission, sky)
    radiance = vwhere(active, radiance + throughput * emission, radiance)
    out = next_bounce(s, hit, r, throughput, radiance, is_hit, seed, depth,
                      steps, segments, normal, config,
                      scene.has_transmission, i)
    return out, s, is_hit, emission


def checkpoint_bounces(config: RenderConfig, n: int) -> bool:
    """Whether a differentiable render recomputes each bounce in the
    backward pass instead of keeping its intermediates: ``bwd_checkpoint``,
    or for ``None`` the reference's rule, on when the estimated residuals
    (``n`` lanes × bounces × ``bwd_resid_bytes_per_seg``) exceed
    ``bwd_resid_budget``."""
    if config.bwd_checkpoint is not None:
        return bool(config.bwd_checkpoint)
    return n * config.bounces * config.bwd_resid_bytes_per_seg \
        > config.bwd_resid_budget


def bvh_carry(ray: Ray, seed, far: float):
    """The packed carry of the primal BVH loop before its first bounce:
    (fs, seeds, counts, active) as ops/shade.py ``path_shade_bvh`` takes
    them, with the values the torch body starts from (throughput 1,
    radiance 0, prev pdf -1, depth ``far``, normal 0, no steps or
    segments, every lane active)."""
    n, dev = ray.o.x.shape[0], ray.o.x.device
    fs = torch.empty((NF, n), dtype=torch.float32, device=dev)
    fs[0:6] = torch.stack([*ray.o, *ray.d])
    fs[6:9] = 1.0
    fs[9:12] = 0.0
    fs[12] = -1.0
    fs[13] = far
    fs[14:17] = 0.0
    return (fs, torch.stack(seed),
            torch.zeros((2, n), dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev))


def _path_trace_bvh(scene: Scene, ray: Ray, seed, config: RenderConfig,
                    far: float) -> PathTraceResult:
    """The primal BVH loop: each bounce ``trace_bvh`` on the carry's rays,
    then ``path_shade_bvh``; the result's fields are rows of the carry."""
    with SPANS.path_lanes:
        fs, seeds, counts, active = bvh_carry(ray, seed, far)
    for i in range(config.bounces):
        with SPANS.path_trace:
            hit = trace_bvh(scene, Ray(Vec3(*fs[0:3]), Vec3(*fs[3:6])),
                            active, max_stack=config.max_stack)
        with SPANS.path_shade:
            fs, seeds, counts, active = path_shade_bvh(
                scene, hit, fs, seeds, counts, active, config, i)
    return PathTraceResult(radiance=Vec3(*fs[9:12]), depth=fs[13],
                           steps=counts[0], segments=counts[1],
                           normal=Vec3(*fs[14:17]))


def path_trace(scene: Scene, ray: Ray, seed, config: RenderConfig,
               prep: TracePrep | None = None,
               far: float = 1000.0) -> PathTraceResult:
    """Trace one path per ray; all rays advance in lockstep through the
    bounce loop under an `active` mask. ``prep`` is the scene's
    :func:`prepare_trace_inputs` (built here when not given; only PALLAS
    and the path kernels read it).

    With ``config.differentiable`` the kernels find hits on detached inputs
    and the hit records are recomputed from the live scene
    (``trace_pallas_diff``, ``trace_occlude_pallas_diff``), so autograd
    reaches every scene tensor the radiance depends on; sampled directions
    and pdfs are detached unless ``config.grad_attached``. With
    ``bwd_checkpoint`` (see :func:`checkpoint_bounces`) each bounce runs
    under ``torch.utils.checkpoint``: the backward pass recomputes it, the
    kernel launch included; BRUTE and UNIT are differentiated as they run.
    ``soft_shadows > 0`` takes shadow visibility from kernel 5
    (``soft_occluded_pallas``) or, with BRUTE and UNIT, ``occlusion_soft``,
    and turns NEE fusion off; ``soft_primary > 0`` relaxes the primary
    hit's silhouette.

    ``Traversal.FUSED`` and ``Traversal.MEGA`` go to their path kernels
    (ops/fused.py ``path_trace_fused``, ops/megakernel.py
    ``path_trace_mega``) within the reference's gates, as the reference
    dispatches them. A primal BVH render that ops/shade.py
    ``path_shade_entry`` takes runs :func:`_path_trace_bvh`."""
    check_supported(scene, config)
    if config.traversal == Traversal.FUSED:
        with SPANS.path_trace:
            return path_trace_fused(scene, ray, seed, config, prep, far=far)
    if config.traversal == Traversal.MEGA:
        with SPANS.path_trace:
            return path_trace_mega(scene, ray, seed, config, prep, far=far)
    entry = path_shade_entry(scene, config, ray)
    if entry == "bvh":
        return _path_trace_bvh(scene, ray, seed, config, far)
    pallas = config.traversal == Traversal.PALLAS
    bvh = config.traversal == Traversal.BVH
    if prep is None and pallas:
        with SPANS.render_prepare:
            prep = prepare_trace_inputs(scene)
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    diff = config.differentiable
    use_nee = config.nee and scene.n_lights > 0
    # BVH resolves shadows with its hard closest-hit query, soft or not.
    soft_shadows = config.soft_shadows > 0.0 and not bvh
    fuse_nee = use_nee and pallas and not prep.superchunks \
        and not soft_shadows
    # The differentiable path reads emitters from the live scene, so light
    # sampling and the MIS weights carry emission and geometry gradients.
    table = None
    if use_nee:
        with SPANS.render_prepare:
            table = prep.lights if pallas and not diff \
                else lights.build_light_table(scene)
    trace = get_trace_fn(config)
    trace_occlude = trace_occlude_pallas_diff if diff \
        else trace_occlude_pallas

    def soft_visibility(shadow, tmax, active):
        with SPANS.path_trace:
            if pallas:
                return soft_occluded_pallas(scene, shadow, tmax, active,
                                            config.soft_shadows, prep)
            return occlusion_soft(scene, shadow, tmax, active,
                                  edge_eps=config.soft_shadows)

    # Per-bounce sort (large PALLAS scenes, where the per-block culling
    # needs coherent blocks after a diffuse bounce; any traversal where
    # sort_rays=True) or group-granular survivor compaction (PALLAS: a
    # stable partition of 128-ray groups by any-live, so dead groups pack
    # into tail blocks whose slab tests all fail). The sort keys dead rays
    # last, so it takes the place of compaction. Per-ray results do not
    # depend on the order.
    sort_rays = config.sort_rays
    if sort_rays is None:
        sort_rays = pallas and scene.isect_mu.shape[1] > 128 * 256
    compact = config.compact_rays
    if compact is None:
        compact = not sort_rays and n >= 65536
    cg = _compaction_group(n)
    compact = bool(compact) and not sort_rays and cg is not None \
        and pallas
    reorder = bool(sort_rays) or compact
    if sort_rays:
        cell_lo, cell_span = morton_frame(scene.detach())
    if entry == "diff":
        with SPANS.path_shade:
            tables = diff_tables(scene)

    def body(i: int, c: _Carry) -> _Carry:
        ray_o, ray_d, throughput, radiance = (c.ray_o, c.ray_d, c.throughput,
                                              c.radiance)
        active, seed, depth, steps = c.active, c.seed, c.depth, c.steps
        segments, prev_pdf, normal, src, pend = (c.segments, c.prev_pdf,
                                                 c.normal, c.src, c.pend)
        with SPANS.path_lanes:
            if reorder:
                if sort_rays:
                    key = torch.where(active, morton_octant_key(
                        ray_o.detach(), ray_d.detach(), cell_lo, cell_span),
                        1 << 14)
                    order = torch.argsort(key, stable=True)

                    def g(x):
                        return x[order]
                else:
                    # A ray whose shadow query is still pending keeps its
                    # group live: the fused launch resolves it this bounce.
                    live = active | pend.active if fuse_nee else active
                    glive = live.view(-1, cg).any(dim=1)
                    ng = glive.shape[0]
                    r_live = torch.cumsum(glive.to(torch.int64), 0)
                    r_dead = torch.cumsum((~glive).to(torch.int64), 0)
                    gdest = torch.where(glive, r_live - 1,
                                        r_live[-1] + r_dead - 1)
                    gorder = torch.empty(ng, dtype=torch.int64, device=dev)
                    gorder[gdest] = torch.arange(ng, device=dev)

                    def g(x):
                        return x.view(-1, cg)[gorder].reshape(-1)

                def gv(v):
                    return Vec3(g(v.x), g(v.y), g(v.z))

                ray_o, ray_d = gv(ray_o), gv(ray_d)
                throughput, radiance, normal = (gv(throughput), gv(radiance),
                                                gv(normal))
                active, depth, steps = g(active), g(depth), g(steps)
                segments, prev_pdf, src = g(segments), g(prev_pdf), g(src)
                seed = (g(seed[0]), g(seed[1]))
                if fuse_nee:
                    pend = DirectLight(
                        Ray(gv(pend.shadow.o), gv(pend.shadow.d)),
                        g(pend.tmax), g(pend.active), gv(pend.direct))

        with SPANS.path_trace:
            r = Ray(ray_o, ray_d)
            if fuse_nee:
                hit, occ = trace_occlude(scene, r, active, pend.shadow,
                                         pend.tmax, pend.active, prep)
                # direct_i lands here, between emission_i and emission_i+1.
                radiance = vwhere(pend.active, radiance + pend.direct
                                  * (~occ).to(torch.float32), radiance)
            else:
                hit = trace(scene, r, active, prep)
        with SPANS.path_shade:
            if entry == "diff":
                return _Carry(*diff_bounce(
                    scene, tables, hit, r, throughput, radiance, active, seed,
                    depth, steps, segments, normal, config, i), src, pend)
            is_hit, steps, segments, s, sky = shade_hit(
                scene, hit, r, active, steps, segments, config)
            if config.soft_primary > 0.0 and i == 0:
                # The primary silhouette relaxed (SoftRas-style): the winner's
                # margin over its open (silhouette) edges gives a coverage
                # alpha, 0 on the silhouette and ~1 a few soft_primary inside;
                # the uncovered share takes the sky, and every surface term of
                # this bounce scales by alpha. Gradients of alpha flow through
                # u and v to vertices, poses and the camera. Later bounces
                # multiply by 1, which the reference does and which changes
                # nothing.
                eo = scene.tri_edge_open[hit.tri.long()]  # (N, 3)
                u, v = hit.u, hit.v
                margin = torch.minimum(
                    torch.minimum(torch.where(eo[:, 0] > 0, u, 1.0),
                                  torch.where(eo[:, 1] > 0, v, 1.0)),
                    torch.where(eo[:, 2] > 0, 1.0 - u - v, 1.0))
                alpha = 2.0 * torch.sigmoid(torch.clamp(margin, min=0.0)
                                            / config.soft_primary) - 1.0
                radiance = vwhere(is_hit, radiance + throughput * sky
                                  * (1.0 - alpha), radiance)
                throughput = throughput * torch.where(is_hit, alpha, 1.0)
            emission = vwhere(is_hit, s.emission, sky)
            if use_nee:
                emission = mis_emission(scene, table, hit, r.d, emission,
                                        is_hit, prev_pdf)
            radiance = vwhere(active, radiance + throughput * emission,
                              radiance)

            if use_nee:
                dl, seed = sample_direct(
                    s, throughput, is_hit, seed, table, config,
                    soft_visibility if soft_shadows else None if pallas
                    else hit_visibility(trace, scene, prep))
                if scene.has_transmission:
                    dl = dl._replace(direct=dl.direct
                                     * (1.0 - s.transmission))
                segments = segments + dl.active.to(torch.int32)
                if fuse_nee:
                    pend = dl
                elif soft_shadows or not pallas:
                    radiance = vwhere(active, radiance + dl.direct, radiance)
                else:
                    # Hard visibility has no derivative almost everywhere:
                    # the kernel sees detached inputs.
                    with SPANS.path_trace:
                        occ = occluded_pallas(scene, dl.shadow.detach(),
                                              dl.tmax.detach(), dl.active,
                                              prep)
                    radiance = vwhere(active, radiance + dl.direct
                                      * (~occ).to(torch.float32), radiance)

            return _Carry(*next_bounce(
                s, hit, r, throughput, radiance, is_hit, seed, depth, steps,
                segments, normal, config, scene.has_transmission, i), src,
                pend)

    with SPANS.path_lanes:
        zero_n = torch.zeros(n, dtype=torch.float32, device=dev)
        zero3 = Vec3(zero_n, zero_n, zero_n)
        carry = _Carry(
            ray.o, ray.d, Vec3(zero_n + 1.0, zero_n + 1.0, zero_n + 1.0),
            zero3, torch.ones(n, dtype=torch.bool, device=dev), seed,
            zero_n + far, torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev), zero_n - 1.0,
            zero3,
            torch.arange(n, device=dev) if reorder else None,
            # No shadow query is pending at bounce 0.
            DirectLight(Ray(zero3, zero3), zero_n,
                        torch.zeros(n, dtype=torch.bool, device=dev), zero3))
    ckpt = diff and checkpoint_bounces(config, n)
    for i in range(config.bounces):
        if ckpt:
            carry = torch.utils.checkpoint.checkpoint(
                body, i, carry, use_reentrant=False,
                preserve_rng_state=False)
        else:
            carry = body(i, carry)

    radiance, pend = carry.radiance, carry.pend
    if fuse_nee:
        # The last bounce's shadow queries: one trailing any-hit launch, on
        # detached inputs.
        with SPANS.path_trace:
            occ = occluded_pallas(scene, pend.shadow.detach(),
                                  pend.tmax.detach(), pend.active, prep)
        with SPANS.path_shade:
            radiance = vwhere(pend.active, radiance + pend.direct
                              * (~occ).to(torch.float32), radiance)

    normal, depth = carry.normal, carry.depth
    steps, segments = carry.steps, carry.segments
    with SPANS.path_lanes:
        if reorder:
            src = carry.src

            def unsort(x):
                return torch.empty_like(x).index_copy_(0, src, x)

            radiance = Vec3(unsort(radiance.x), unsort(radiance.y),
                            unsort(radiance.z))
            normal = Vec3(unsort(normal.x), unsort(normal.y), unsort(normal.z))
            depth, steps, segments = unsort(depth), unsort(steps), \
                unsort(segments)
    return PathTraceResult(radiance=radiance, depth=depth, steps=steps,
                           segments=segments, normal=normal)
