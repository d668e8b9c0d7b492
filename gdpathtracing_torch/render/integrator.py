"""The path-tracing integrator: bounce loop over a ray wavefront.

Port of the standard loop of gdpathtracing_tpu/render/integrator.py for
``Traversal.PALLAS`` without NEE: ``lax.fori_loop`` becomes a Python loop
over bounces, and the group-granular survivor compaction (with the final
unsort) is kept. Light transport is the reference's: BRDF importance
sampling, ``radiance += throughput * emission`` per segment, sky on a miss,
a hard bounce cap and a ray-origin offset along the shading normal.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3, where as vwhere
from gdpathtracing_torch.ops.intersect import (prepare_trace_inputs,
                                               trace_pallas)
from gdpathtracing_torch.render import brdf
from gdpathtracing_torch.render.shading import shading_from_rows
from gdpathtracing_torch.render.sky import sample_sky
from gdpathtracing_torch.render.types import HitInfo, Ray
from gdpathtracing_torch.scene.scene import Scene

TraceFn = Callable[[Scene, Ray, torch.Tensor], HitInfo]


def check_supported(scene: Scene, config: RenderConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item (queue 1) that
    ports it, for anything outside the ported slice: the standard loop
    (``regen=False``) over ``Traversal.PALLAS``, primal, no NEE. Scenes of
    more than 16 chunks raise in ops/intersect.py prepare_trace_inputs."""
    def no(what, item):
        raise NotImplementedError(
            f"{what} is not ported to gdpathtracing_torch yet "
            f"(ROADMAP queue 1, item {item})")

    if config.traversal != Traversal.PALLAS:
        oracle = config.traversal in (Traversal.BRUTE, Traversal.UNIT)
        no(f"Traversal.{config.traversal.name}", 3 if oracle else 13)
    if config.regen is not False:
        no("the path-regeneration loop (regen=None or True; pass "
           "regen=False)", 6)
    if config.nee:
        no("next-event estimation (nee=True)", 7)
    if config.differentiable or config.soft_primary > 0.0:
        no("the differentiable path", 9)
    if config.soft_shadows > 0.0:
        no("soft shadows", 9)
    if config.sort_rays:
        no("per-bounce ray sorting (sort_rays=True)", 8)
    if config.rr_start > 0:
        no("Russian roulette (rr_start > 0)", 3)
    if scene.has_transmission:
        no("dielectric transmission", 3)


def get_trace_fn(config: RenderConfig, scene: Scene) -> TraceFn:
    """Traversal closure with the per-scene trace table built once."""
    check_supported(scene, config)
    prep = prepare_trace_inputs(scene)

    def pallas_fn(scene_, ray, active):
        # A different scene object gets its own (fresh) table.
        return trace_pallas(scene_, ray, active,
                            prep=prep if scene_ is scene else None)

    return pallas_fn


class PathTraceResult(NamedTuple):
    radiance: Vec3           # (N,) per ray
    depth: torch.Tensor      # (N,) first-hit distance (far on a miss)
    steps: torch.Tensor      # (N,) triangle tests
    segments: torch.Tensor   # (N,) ray segments traced (≤ bounces)
    normal: Vec3             # (N,) first-hit shading normal (0 on a miss)


def _compaction_group(n: int) -> int | None:
    return next((g for g in (128, 32, 8) if n % g == 0), None)


def path_trace(scene: Scene, ray: Ray, seed, config: RenderConfig,
               trace_fn: TraceFn | None = None,
               far: float = 1000.0) -> PathTraceResult:
    """Trace one path per ray; all rays advance in lockstep through the
    bounce loop under an `active` mask."""
    check_supported(scene, config)
    if trace_fn is None:
        trace_fn = get_trace_fn(config, scene)
    n = ray.o.x.shape[0]
    dev = ray.o.x.device

    # Group-granular survivor compaction: stable partition of 128-ray
    # groups by any-live, so dead groups pack into tail blocks whose slab
    # tests all fail. Per-ray results do not depend on the order.
    compact = config.compact_rays
    if compact is None:
        compact = n >= 65536
    cg = _compaction_group(n)
    compact = bool(compact) and cg is not None

    zero_n = torch.zeros(n, dtype=torch.float32, device=dev)
    ray_o, ray_d = ray.o, ray.d
    throughput = Vec3(zero_n + 1.0, zero_n + 1.0, zero_n + 1.0)
    radiance = Vec3(zero_n, zero_n, zero_n)
    normal = Vec3(zero_n, zero_n, zero_n)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    depth = zero_n + far
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    segments = torch.zeros(n, dtype=torch.int32, device=dev)
    src = torch.arange(n, device=dev) if compact else None

    for i in range(config.bounces):
        if compact:
            glive = active.view(-1, cg).any(dim=1)
            ng = glive.shape[0]
            r_live = torch.cumsum(glive.to(torch.int64), 0)
            r_dead = torch.cumsum((~glive).to(torch.int64), 0)
            gdest = torch.where(glive, r_live - 1, r_live[-1] + r_dead - 1)
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
            segments, src = g(segments), g(src)
            seed = (g(seed[0]), g(seed[1]))

        r = Ray(ray_o, ray_d)
        hit = trace_fn(scene, r, active)
        is_hit = hit.hit & active
        steps = steps + torch.where(active, hit.steps, 0)
        segments = segments + active.to(torch.int32)

        s = shading_from_rows(scene, hit, r)
        sky = sample_sky(ray_d, config, scene)
        emission = vwhere(is_hit, s.emission, sky)
        radiance = vwhere(active, radiance + throughput * emission, radiance)

        if i == 0:  # first-hit AOVs
            dist = (s.position - ray_o).length()
            depth = torch.where(is_hit, dist, depth)
            normal = vwhere(is_hit, s.normal, normal)

        # Next segment: BRDF sampling.
        (r1, r2), seed = rng.pcg2d(seed)
        new_dir = brdf.sample_brdf(s, r1, r2)
        pdf = brdf.brdf_pdf(s, new_dir)
        lambert_in = s.normal.dot(new_dir)
        f = brdf.eval_brdf(s, new_dir)
        scale = torch.where(pdf > 1e-12,
                            lambert_in / torch.clamp(pdf, min=1e-12), 0.0)
        survive = is_hit & (lambert_in > 0.0) & (pdf > 1e-12)
        new_o = s.position + s.normal * config.ray_eps
        ray_o = vwhere(survive, new_o, ray_o)
        ray_d = vwhere(survive, new_dir, ray_d)
        throughput = vwhere(survive, throughput * (f * scale), throughput)
        active = survive

    if compact:
        def unsort(x):
            return torch.empty_like(x).index_copy_(0, src, x)

        radiance = Vec3(unsort(radiance.x), unsort(radiance.y),
                        unsort(radiance.z))
        normal = Vec3(unsort(normal.x), unsort(normal.y), unsort(normal.z))
        depth, steps, segments = unsort(depth), unsort(steps), \
            unsort(segments)
    return PathTraceResult(radiance=radiance, depth=depth, steps=steps,
                           segments=segments, normal=normal)
