"""Path-regeneration frame loop: a persistent, always-full wavefront.

Port of gdpathtracing_tpu/render/regen.py, the default frame loop of every
primal ``Traversal.PALLAS`` render. Instead of letting the lanes of dead
paths idle until the last bounce, every iteration refills them with the
next unstarted paths of the frame's pool: a fresh camera ray is pure
arithmetic of its path id (pixel = id % n_pix, sample = id // n_pix, the
PCG2D seed of (pixel, frame·spp + sample)), so each path draws exactly the
random numbers, and runs exactly the per-segment arithmetic, of the
standard loop (render/integrator.py), and the frame equals that loop's.

One iteration traces one segment of every live lane (kernel 1, or on a
scene of more than 16 chunks a superchunk kernel; with NEE also one shadow
query per lane, kernel 2), shades it and samples the next
direction. Then the lanes are permuted: live lanes sorted by the Morton
cell of their origin and the octant of their direction (blocks of similar
rays sweep fewer chunks), then this iteration's dead, then the lanes that
were dead before. Finished paths are retired by one contiguous append to
a column-major log (or, ``regen_retire="scatter"``, written to their
pixel at once), and the dead tail is refilled from the pool. When the pool
is empty and the live lanes fit, the sorted live prefix moves on at a
smaller wavefront (the drain), and the log is indexed by path id at the
end.

``lax.while_loop`` becomes a host loop: each iteration reads the two counts
the log append and the loop condition need with one small ``.tolist()``.
Lane state is carried as an (17, nw) float32 and a (6, nw) int64 stack, so
the permute is two gathers; the PCG2D seeds ride the int64 stack as they
are. Regen's fused NEE, its frontier march, the first-chunk sort key and
the TPU package's timing hooks are not ported (see check_regen_supported).
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3, where as vwhere
from gdpathtracing_torch.ops.intersect import (BN, occluded_pallas,
                                               prepare_trace_inputs,
                                               trace_pallas)
from gdpathtracing_torch.render import brdf
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.integrator import (check_supported,
                                                   mis_emission,
                                                   morton_frame,
                                                   morton_octant_key,
                                                   not_ported, sample_direct)
from gdpathtracing_torch.render.shading import get_shading_data
from gdpathtracing_torch.render.sky import sample_sky
from gdpathtracing_torch.render.types import Ray
from gdpathtracing_torch.scene.scene import Scene

# Rows of the float lane stack ...
_O, _D, _TP, _RAD = 0, 3, 6, 9          # Vec3 rows start here
_PREV_PDF, _DEPTH, _NRM = 12, 13, 14
_LOG_F = [9, 10, 11, 13, 14, 15, 16]    # radiance, depth, normal
# ... and of the int64 lane stack.
_SEED, _PID, _BOUNCE, _STEPS, _SEGS = 0, 2, 3, 4, 5
_STEPS_MAX = (1 << 19) - 1  # the log path clamps steps (as the reference)


def regen_supported(scene: Scene, config: RenderConfig) -> bool:
    """The reference's gate for the regeneration frame loop."""
    return (config.traversal in (Traversal.PALLAS, Traversal.UNIT,
                                 Traversal.BRUTE)
            and not config.differentiable
            and config.soft_shadows == 0.0
            and config.soft_primary == 0.0)


def regen_auto(scene: Scene, config: RenderConfig) -> bool:
    """``config.regen=None`` policy: every supported PALLAS render."""
    return (config.traversal == Traversal.PALLAS
            and regen_supported(scene, config))


def check_regen_supported(scene: Scene, config: RenderConfig) -> None:
    """Raise NotImplementedError, naming its ROADMAP item (queue 1), for a
    regen configuration outside the ported slice."""
    check_supported(scene, config)
    if config.regen_march:
        not_ported("regen's frontier march (regen_march=True)", 13)
    if config.regen_sort_key == "chunk":
        not_ported("regen's first-chunk lane sort key "
                   "(regen_sort_key='chunk')", 14)
    if config.nee and config.regen_fuse_nee:
        not_ported("regen's fused NEE (regen_fuse_nee=True)", 14)


def _drain_sizes(config: RenderConfig, nw: int, n_paths: int,
                 compact: bool) -> list[int]:
    """Wavefronts of the drain stages (the reference's two-stage rule)."""
    if not compact or config.regen_drain is False:
        return []
    dn = config.regen_drain_wavefront
    if dn is None:
        dn = max(BN, (nw // 4) // BN * BN)
    if not (dn < nw and (config.regen_drain is True
                         or n_paths >= 2 * nw)):
        return []
    dn2 = max(BN, (dn // 4) // BN * BN)
    return [dn, dn2] if dn2 < dn else [dn]


def render_radiance_regen(scene: Scene, camera: Camera,
                          config: RenderConfig, frame_index: int = 0,
                          return_stats: bool = False):
    """Full-frame trace with path regeneration on ``scene.device``. Returns
    FrameAOVs (the contract of renderer.render_radiance); with
    ``return_stats``, (FrameAOVs, {"iters", "lane_slots", "n_blocks"}):
    iterations over all stages, lanes traced summed over them, and 256-ray
    blocks of the first stage. The iterations are also added to
    ``render_radiance_regen.iterations``."""
    from gdpathtracing_torch.render.renderer import FrameAOVs

    check_regen_supported(scene, config)
    prep = prepare_trace_inputs(scene)
    dev = scene.device
    camera = camera.to(dev)
    w, h = camera.width, camera.height
    n_pix = w * h
    n_paths = n_pix * config.spp
    nw = min(config.regen_wavefront, -(-n_paths // BN) * BN)
    frame_index = int(frame_index)
    use_nee = config.nee and scene.n_lights > 0
    compact = config.compact_rays is not False
    use_log = config.regen_retire == "log" and compact
    sort_lanes = (config.sort_rays is not False) and compact
    cell_lo, cell_span = morton_frame(scene)

    def spawn(path_id):
        """Camera ray and RNG stream of path ``path_id`` (pixel-major
        within each sample), as the standard renderer spawns it."""
        pix = path_id % n_pix
        sample = torch.div(path_id, n_pix, rounding_mode="floor")
        seed = rng.prng_seed(pix % w, torch.div(pix, w, rounding_mode="floor"),
                             frame_index * config.spp + sample)
        return camera.generate_rays(pix, seed, config)

    def lane_sort_key(o: Vec3, d: Vec3, alive, fresh):
        """Morton(origin cell, 8^3) * 8 + octant(direction) for live
        lanes; then this iteration's dead (the log appends them as one
        block), then the lanes that were dead before."""
        return torch.where(alive,
                           morton_octant_key(o, d, cell_lo, cell_span),
                           torch.where(fresh, 1 << 14, 1 << 15))

    # Lane state: float rows [o3 d3 throughput3 radiance3 prev_pdf depth
    # normal3], int64 rows [seed2 pid bounce steps segs].
    lane = torch.arange(nw, device=dev)
    ray0, seed0 = spawn(lane)
    zero = torch.zeros(nw, dtype=torch.float32, device=dev)
    fs = torch.stack([*ray0.o, *ray0.d, zero + 1.0, zero + 1.0, zero + 1.0,
                      zero, zero, zero, zero - 1.0, zero + camera.far,
                      zero, zero, zero])
    izero = torch.zeros(nw, dtype=torch.int64, device=dev)
    ints = torch.stack([seed0[0], seed0[1], lane, izero, izero, izero])
    # What a fresh path starts with besides its ray and seed.
    spawn_f = fs[_TP:]
    spawn_i = ints[_BOUNCE:]
    active = lane < n_paths
    next_path = nact = min(nw, n_paths)

    if use_log:
        log_f = torch.zeros((len(_LOG_F), n_paths + nw), dtype=torch.float32,
                            device=dev)
        log_i = torch.zeros((3, n_paths + nw), dtype=torch.int64, device=dev)
        retired = 0
    else:  # one extra column takes the writes of lanes that retire nothing
        out_f = torch.zeros((len(_LOG_F), n_paths + 1), dtype=torch.float32,
                            device=dev)
        out_i = torch.zeros((2, n_paths + 1), dtype=torch.int64, device=dev)

    stages = [nw] + _drain_sizes(config, nw, n_paths, compact)
    iters = lane_slots = 0
    for k, size in enumerate(stages):
        # A drain stage takes over the live prefix of the sorted lanes.
        fs, ints, active = fs[:, :size], ints[:, :size], active[:size]
        threshold = stages[k + 1] if k + 1 < len(stages) else 0
        lane = torch.arange(size, device=dev)
        while next_path < n_paths or nact > threshold:
            ray_o = Vec3(*fs[_O:_O + 3])
            ray_d = Vec3(*fs[_D:_D + 3])
            tp = Vec3(*fs[_TP:_TP + 3])
            rad = Vec3(*fs[_RAD:_RAD + 3])
            prev_pdf, depth1 = fs[_PREV_PDF], fs[_DEPTH]
            normal1 = Vec3(*fs[_NRM:_NRM + 3])
            seed = (ints[_SEED], ints[_SEED + 1])
            pid, bounce = ints[_PID], ints[_BOUNCE]
            steps, segs = ints[_STEPS], ints[_SEGS]

            # ---- one path segment: the standard loop's body ----
            r = Ray(ray_o, ray_d)
            hit = trace_pallas(scene, r, active, prep)
            steps = steps + torch.where(active, hit.steps, 0)
            is_hit = hit.hit & active
            segs = segs + active.to(torch.int64)

            s = get_shading_data(scene, hit, r)
            sky = sample_sky(ray_d, config, scene)
            emission = vwhere(is_hit, s.emission, sky)
            if use_nee:
                emission = mis_emission(scene, prep.lights, hit, r.d,
                                        emission, is_hit, prev_pdf)
            rad = vwhere(active, rad + tp * emission, rad)

            if use_nee:
                dl, seed = sample_direct(s, tp, is_hit, seed, prep.lights,
                                         config)
                occ = occluded_pallas(scene, dl.shadow, dl.tmax, dl.active,
                                      prep)
                segs = segs + dl.active.to(torch.int64)
                rad = vwhere(active, rad + dl.direct
                             * (~occ).to(torch.float32), rad)

            first = (bounce == 0) & is_hit
            depth1 = torch.where(first, (s.position - ray_o).length(),
                                 depth1)
            normal1 = vwhere(first, s.normal, normal1)

            (r1, r2), seed = rng.pcg2d(seed)
            new_dir = brdf.sample_brdf(s, r1, r2)
            pdf = brdf.brdf_pdf(s, new_dir)
            lambert_in = s.normal.dot(new_dir)
            f = brdf.eval_brdf(s, new_dir)
            scale = torch.where(pdf > 1e-12,
                                lambert_in / torch.clamp(pdf, min=1e-12), 0.0)
            survive = is_hit & (lambert_in > 0.0) & (pdf > 1e-12)
            ray_o = vwhere(survive, s.position + s.normal * config.ray_eps,
                           ray_o)
            ray_d = vwhere(survive, new_dir, ray_d)
            tp = vwhere(survive, tp * (f * scale), tp)
            prev_pdf = torch.where(survive, pdf, -1.0)
            bounce = bounce + active.to(torch.int64)
            alive = active & survive & (bounce < config.bounces)
            dead_now = active & ~alive
            n_alive, n_fresh = torch.stack(
                [alive.sum(), dead_now.sum()]).tolist()

            fs = torch.stack([*ray_o, *ray_d, *tp, *rad, prev_pdf, depth1,
                              *normal1])
            ints = torch.stack([seed[0], seed[1], pid, bounce, steps, segs])
            if not use_log:  # retire finished paths to their slot at once
                slot = torch.where(dead_now, pid, n_paths)
                out_f[:, slot] = fs[_LOG_F]
                out_i[:, slot] = ints[_STEPS:_SEGS + 1]

            # ---- permute: live | freshly dead | dead before ----
            if compact:
                if sort_lanes:
                    perm = torch.argsort(
                        lane_sort_key(ray_o, ray_d, alive, dead_now),
                        stable=True)
                else:
                    stale = ~alive & ~dead_now
                    dest = torch.where(
                        alive, torch.cumsum(alive, 0),
                        torch.where(dead_now,
                                    n_alive + torch.cumsum(dead_now, 0),
                                    n_alive + n_fresh
                                    + torch.cumsum(stale, 0))) - 1
                    perm = torch.empty_like(lane)
                    perm[dest] = lane
                fs, ints = fs[:, perm], ints[:, perm]
                alive = lane < n_alive
            if use_log:  # the freshly dead block, appended in one copy
                fresh = slice(n_alive, n_alive + n_fresh)
                log_f[:, retired:retired + n_fresh] = fs[_LOG_F, fresh]
                log_i[0, retired:retired + n_fresh] = torch.clamp(
                    ints[_STEPS, fresh], max=_STEPS_MAX)
                log_i[1:, retired:retired + n_fresh] = \
                    ints[[_SEGS, _PID], fresh]
                retired += n_fresh

            # ---- regenerate: refill dead lanes from the path pool ----
            dead = ~alive
            new_id = next_path + torch.cumsum(dead, 0) - 1
            can = dead & (new_id < n_paths)
            new_id = torch.clamp(new_id, max=n_paths - 1)
            ray_new, seed_new = spawn(new_id)
            fresh_f = torch.cat([torch.stack([*ray_new.o, *ray_new.d]),
                                 spawn_f[:, :size]])
            fresh_i = torch.cat([torch.stack([*seed_new, new_id]),
                                 spawn_i[:, :size]])
            fs = torch.where(can, fresh_f, fs)
            ints = torch.where(can, fresh_i, ints)
            active = alive | can
            nact = n_alive + min(size - n_alive, n_paths - next_path)
            next_path = min(next_path + size - n_alive, n_paths)
            iters += 1
            lane_slots += size

    if use_log:
        # Every path retired exactly once: index the log by path id.
        pos = torch.empty(n_paths, dtype=torch.int64, device=dev)
        pos[log_i[2, :n_paths]] = torch.arange(n_paths, device=dev)
        vals, steps, segs = log_f[:, pos], log_i[0, pos], log_i[1, pos]
    else:
        vals = out_f[:, :n_paths]
        steps, segs = out_i[0, :n_paths], out_i[1, :n_paths]

    # Samples of a pixel: the standard renderer's reduction.
    per = [slice(k * n_pix, (k + 1) * n_pix) for k in range(config.spp)]
    acc = torch.zeros((3, n_pix), dtype=torch.float32, device=dev)
    depth = vals[3, per[0]]
    for p in per:
        acc = acc + vals[0:3, p]
        depth = torch.minimum(depth, vals[3, p])
    rgb = acc * (1.0 / config.spp)
    aovs = FrameAOVs(
        radiance=rgb.T.reshape(h, w, 3),
        depth=depth.reshape(h, w),
        steps=sum(steps[p] for p in per).to(torch.int32).reshape(h, w),
        segments=sum(segs[p] for p in per).to(torch.int32).reshape(h, w),
        normal=vals[4:7, per[0]].T.reshape(h, w, 3))
    render_radiance_regen.iterations += iters
    if return_stats:
        return aovs, {"iters": iters, "lane_slots": lane_slots,
                      "n_blocks": nw // BN}
    return aovs


render_radiance_regen.iterations = 0
