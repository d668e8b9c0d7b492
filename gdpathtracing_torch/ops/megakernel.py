"""Per-bounce path-tracing megakernel (``Traversal.MEGA``) — port of
gdpathtracing_tpu/ops/megakernel.py.

One kernel launch per bounce runs the whole bounce of a packed wavefront:
closest hit, winner rows, shading, the NEE light sample and its shadow
any-hit, MIS, BRDF sampling, Russian roulette and the PCG2D stream. The
per-ray state crosses device memory once per bounce as a (24, N) f32 plus
(8, N) i32 matrix instead of ~40 arrays and dozens of elementwise launches.

The wrapper :func:`mega_step`, like the traversal wrappers of
ops/intersect.py,

- on a CUDA tensor launches kernel 10 (``csrc/mega_step.cu``, built by
  nvcc at first use) and counts the launch in ``mega_step.launches``;
- on a CPU tensor runs :func:`mega_step_plain`, which composes kernel 1's
  and kernel 2's plain versions (``closest_hit_rows_plain``,
  ``occluded_plain``) with the port's shading, light, sky and BRDF modules
  in the reference's order, and which the CPU tests hold against JAX.

Between bounces :func:`path_trace_mega` stably sorts the state by the
direction octant of the live rays, dead rays last (``compact_rays``; the
reference's 9-bucket counting sort), so that live rays fill the leading
blocks and dead ones leave their blocks at once; the last bounce is
followed by the unsort. Every output is per ray, so the frame is the same
bit for bit with the sort on or off.

Scope (``mega_supported``): no textures, environment map, transmission or
soft shadows, a flat scene (at most 16 chunks) and at most 4096 emitters.
Where the TPU kernel visited chunks near to far per block, both walks here
go in index order with each ray gated by its own slab test: the winner,
the occlusion and ``steps`` then do not depend on the block, and ``steps``
equals the port's PALLAS ``steps`` (ROADMAP §3).
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3, where as vwhere
from gdpathtracing_torch.ops.intersect import (BN, BT, FS_R, IS_R, LT_R,
                                               MAX_FLAT_CHUNKS, TracePrep,
                                               _FAR, _S3, _block_any,
                                               _check_inputs, _launch, _MISS,
                                               closest_hit_rows_plain,
                                               occluded_plain,
                                               prepare_trace_inputs)
from gdpathtracing_torch.render import brdf, lights
from gdpathtracing_torch.render.shading import _finish
from gdpathtracing_torch.render.sky import sample_sky
from gdpathtracing_torch.render.types import Ray, ShadingInfo
from gdpathtracing_torch.scene.scene import Scene

# State rows: f32 0:3 o | 3:6 d | 6:9 throughput | 9:12 radiance | 12 active
# | 13 depth | 14 prev_pdf | 15:18 first normal | 18:24 pad; i32 0 seed_x |
# 1 seed_y | 2 steps | 3 segments | 4:8 pad. The light block is (L, 18):
# LightTable.rows (17) | cdf.
MAX_MEGA_CHUNKS = MAX_FLAT_CHUNKS
MAX_MEGA_LIGHTS = 4096
_MASK32 = 0xFFFFFFFF


def mega_supported(scene: Scene, config: RenderConfig) -> bool:
    """The reference's gate for ``Traversal.MEGA``."""
    nc = scene.isect_mu.shape[1] // BT
    return (not scene.has_env and not scene.has_transmission
            and not scene.has_textures and not scene.has_mr_textures
            and nc <= MAX_MEGA_CHUNKS
            and scene.n_lights <= MAX_MEGA_LIGHTS
            and config.soft_shadows == 0.0)


def sky_constants(config: RenderConfig) -> tuple[float, ...]:
    """The analytic sky as the path kernels take it: the horizon colour
    and zenith - horizon, each difference taken in double as render/sky.py
    takes it from the Python config."""
    hor, zen = config.sky_horizon, config.sky_zenith
    return tuple(hor) + tuple(z - h for z, h in zip(zen, hor))


def _build_light_block(table: lights.LightTable | None,
                       device) -> torch.Tensor:
    """(L, 18) light block: ``LightTable.rows`` | cdf; (0, 18) without
    emitters."""
    if table is None:
        return torch.zeros((0, LT_R), dtype=torch.float32, device=device)
    return torch.cat([table.rows, table.cdf[:, None]], dim=1).contiguous()


def _sample_light_block(lt: torch.Tensor, position: Vec3, r_pick, r1, r2
                        ) -> lights.LightSample:
    """``lights.sample_light`` on the light block (the reference's
    ``_sample_light_block``: the same pick, clamp(#{cdf < r}, 0, L-1), and
    the same arithmetic term for term)."""
    return lights.sample_light_rows(lt[:, :17], lt[:, 17], position, r_pick,
                                    r1, r2)


def _shade_rows(rows, u, v, front, o: Vec3, d: Vec3, t) -> ShadingInfo:
    """render/shading.py ``shading_from_rows`` on (48, N) winner rows
    without a scene (MEGA runs only untextured scenes): the same math."""
    w = 1.0 - u - v
    normal = Vec3(
        rows[0] * w + rows[3] * u + rows[6] * v,
        rows[1] * w + rows[4] * u + rows[7] * v,
        rows[2] * w + rows[5] * u + rows[8] * v,
    ).normalize(eps=1e-20)
    normal = vwhere(front, normal, -normal)
    albedo = Vec3(rows[17], rows[18], rows[19])
    energy = torch.clamp(rows[23], min=0.0)
    emission = Vec3(rows[20] * energy, rows[21] * energy, rows[22] * energy)
    return _finish(Ray(o, d), t, normal, albedo, emission, rows[24],
                   rows[25], rows[27], rows[28])


def _park(act, x: Vec3, value: float) -> Vec3:
    return Vec3(*(torch.where(act, c, value) for c in x))


def _seed(istate) -> tuple[torch.Tensor, torch.Tensor]:
    """The PCG2D words of the i32 state as core/rng.py carries them."""
    return (istate[0].to(torch.int64) & _MASK32,
            istate[1].to(torch.int64) & _MASK32)


def _as_i32(word: torch.Tensor) -> torch.Tensor:
    """A uint32 word carried in int64 as its int32 bit pattern."""
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _add_counts(counts: dict, tests: float, walk: dict) -> None:
    """Adds a walk's tests and its two slot counts to ``counts``."""
    counts["tests"] = counts.get("tests", 0.0) + tests
    for k in ("slots", "thread_slots"):
        counts[k] = counts.get(k, 0.0) + walk[k]


def mega_step_plain(fstate, istate, bounds, sub_bounds, mu, mv, mw, tab, lt,
                    bounce: int, config: RenderConfig,
                    counts: dict | None = None):
    """Plain PyTorch version of csrc/mega_step.cu: one bounce of the packed
    state (see its contract), through kernel 1's and kernel 2's plain
    versions and the port's shading, light, sky and BRDF modules, in the
    reference's order (megakernel.py:182-478). Returns (fstate, istate).

    A ``counts`` dict receives the work these inputs need, added to what
    it holds: ``tests``, the ray-triangle tests of both walks; ``slots``,
    the thread-slots kernel 10's block-cooperative walks spend on them
    (``closest_hit_rows_plain``'s and ``occluded_plain``'s); and
    ``thread_slots``, those a thread per ray would (every lane of a block
    on each chunk some ray of it needs, in each walk); and it is given
    ``shadow_rays``, the shadow queries posted. A block of dead rays walks
    nothing: its parked rays pass no gate."""
    fs = fstate
    nee = config.nee and lt.shape[0] > 0
    act = fs[12] > 0.0
    o = Vec3(fs[0], fs[1], fs[2])
    d = Vec3(fs[3], fs[4], fs[5])
    one = torch.ones_like(fs[0])

    # Phase A: the closest hit, dead rays parked outside the scene.
    po, pd = _park(act, o, _FAR), _park(act, d, _S3)
    walk_counts = {} if counts is not None else None
    rows = closest_hit_rows_plain(torch.stack([*po, one]),
                                  torch.stack([*pd, one * 0.0]), bounds, mu,
                                  mv, mw, tab, counts=walk_counts)
    t = rows[40]
    hit = (t < _MISS) & act
    if counts is not None:
        _add_counts(counts, float(rows[45].sum()), walk_counts)
    u = torch.clamp(rows[41], 0.0, 1.0)
    v = torch.clamp(rows[42], 0.0, 1.0)
    s = _shade_rows(rows, u, v, rows[43] < 0.0, o, d, t)
    seed = _seed(istate)

    emission = vwhere(hit, s.emission, sample_sky(d, config))
    if nee:
        # Epilogue A and phase B: the shadow ray of each hit's emitter
        # sample (two draws, not kept) and its any-hit.
        (lr1, lr2), sd = rng.pcg2d(seed)
        (lr3, _), seed = rng.pcg2d(sd)
        ls = _sample_light_block(lt, s.position, lr3, lr1, lr2)
        cos_i = s.normal.dot(ls.wi)
        sh_act = hit & (cos_i > 0.0) & torch.isfinite(ls.pdf_solid)
        so = s.position + s.normal * config.ray_eps
        tlim = torch.where(sh_act, ls.dist * (1.0 - 1e-3), 0.0)
        occ = occluded_plain(torch.stack([*_park(sh_act, so, _FAR), one]),
                             torch.stack([*_park(sh_act, ls.wi, _S3),
                                          one * 0.0]),
                             tlim, bounds, sub_bounds, mu, mv, mw,
                             counts=walk_counts)
        if counts is not None:
            _add_counts(counts, float(occ.tests.sum()), walk_counts)
            counts["shadow_rays"] = int(sh_act.sum())
        occ = occ.occ

        # Epilogue B: MIS weight of the emission (lights.light_pdf_from_rows
        # is the reference's _light_pdf_rows term for term).
        pl_pdf = lights.light_pdf_from_rows(rows, d, t)
        prev_pdf = fs[14]
        pb = torch.clamp(prev_pdf, min=0.0)
        w_mis = torch.where(
            (prev_pdf > 0.0) & hit & (pl_pdf > 0.0),
            (pb * pb) / torch.clamp(pb * pb + pl_pdf * pl_pdf, min=1e-20),
            1.0)
        emission = emission * w_mis

    tp = Vec3(fs[6], fs[7], fs[8])
    rad = Vec3(fs[9], fs[10], fs[11])
    rad = vwhere(act, rad + tp * emission, rad)
    segs_add = act.to(torch.int32)

    if nee:
        visibility = 1.0 - occ.to(torch.float32)
        segs_add = segs_add + sh_act.to(torch.int32)
        f_l = brdf.eval_brdf(s, ls.wi)
        pb_l = brdf.brdf_pdf(s, ls.wi)
        pdf_solid = ls.pdf_solid
        w_l = (pdf_solid * pdf_solid) / torch.clamp(
            pdf_solid * pdf_solid + pb_l * pb_l, min=1e-20)
        scale_l = torch.where(
            sh_act & (pdf_solid > 1e-12) & torch.isfinite(pdf_solid),
            cos_i * w_l / torch.clamp(pdf_solid, min=1e-12),
            0.0) * visibility
        direct = tp * f_l * ls.emission * scale_l
        rad = vwhere(act, rad + direct, rad)

    first = hit if bounce == 0 else torch.zeros_like(hit)
    depth = torch.where(first, (s.position - o).length(), fs[13])
    n0 = vwhere(first, s.normal, Vec3(fs[15], fs[16], fs[17]))

    (r1, r2), seed = rng.pcg2d(seed)
    new_dir = brdf.sample_brdf(s, r1, r2)
    pdf = brdf.brdf_pdf(s, new_dir)
    lambert_in = s.normal.dot(new_dir)
    f = brdf.eval_brdf(s, new_dir)
    scale = torch.where(pdf > 1e-12,
                        lambert_in / torch.clamp(pdf, min=1e-12), 0.0)
    mult = f * scale
    survive = hit & (lambert_in > 0.0) & (pdf > 1e-12)
    if config.rr_start > 0:
        # Russian roulette: the draw on every bounce, the kill from bounce
        # rr_start on.
        (r5, _), seed = rng.pcg2d(seed)
        lum = torch.maximum(tp.x * mult.x,
                            torch.maximum(tp.y * mult.y, tp.z * mult.z))
        p = torch.clamp(lum, config.rr_min_p, 1.0)
        if bounce >= config.rr_start:
            survive = survive & (r5 < p)
            mult = mult * (1.0 / p)
    new_o = s.position + s.normal * config.ray_eps

    def sel(a, b):
        return torch.where(survive, a, b)

    out = torch.stack([
        sel(new_o.x, fs[0]), sel(new_o.y, fs[1]), sel(new_o.z, fs[2]),
        sel(new_dir.x, fs[3]), sel(new_dir.y, fs[4]), sel(new_dir.z, fs[5]),
        sel(tp.x * mult.x, fs[6]), sel(tp.y * mult.y, fs[7]),
        sel(tp.z * mult.z, fs[8]), rad.x, rad.y, rad.z,
        survive.to(torch.float32), depth, sel(pdf, -1.0), n0.x, n0.y, n0.z,
        *fs[18:]])
    # A block whose rays are all dead passes its state through (the rest
    # of a dead ray's state is unchanged anyway; only its seeds would move).
    live = _block_any(act) > 0.0
    ois = torch.stack([
        torch.where(live, _as_i32(seed[0]), istate[0]),
        torch.where(live, _as_i32(seed[1]), istate[1]),
        istate[2] + torch.where(act, rows[45].to(torch.int32), 0),
        istate[3] + segs_add, *istate[4:]])
    return out, ois


@torch.no_grad()
def mega_step(fstate, istate, bounds, sub_bounds, mu, mv, mw, tab, lt,
              bounce: int, config: RenderConfig):
    """One bounce of the packed path state ``fstate`` (24, N) f32 and
    ``istate`` (8, N) i32 over the flat chunked triangles (inflated chunk
    ``bounds`` (8, nc), ``sub_bounds`` (8, 2·nc), ``mu``/``mv``/``mw``
    (4, E), winner table ``tab`` (40, E)) with the light block ``lt``
    (L, 18; NEE when ``config.nee`` and L > 0). Returns the new
    (fstate, istate).

    CUDA tensors launch kernel 10 (counted in ``mega_step.launches``); CPU
    tensors run :func:`mega_step_plain`. Anything else raises."""
    n, e = _check_inputs(fstate=fstate, istate=istate, bounds=bounds,
                         sub_bounds=sub_bounds, mu=mu, mv=mv, mw=mw, tab=tab,
                         lt=lt)
    if e // BT > MAX_MEGA_CHUNKS:
        raise ValueError(f"mega_step takes flat scenes only (at most "
                         f"{MAX_MEGA_CHUNKS} chunks, got {e // BT})")
    if fstate.device.type == "cpu":
        return mega_step_plain(fstate, istate, bounds, sub_bounds, mu, mv, mw,
                               tab, lt, bounce, config)
    nee = bool(config.nee) and lt.shape[0] > 0
    fs_out = torch.empty_like(fstate)
    is_out = torch.empty_like(istate)
    _launch("mega_step", (fstate, istate, bounds, sub_bounds, mu, mv, mw, tab,
                          lt, fs_out, is_out),
            n, e, lt.shape[0], int(bounce), int(nee), int(config.rr_start),
            floats=(config.ray_eps, config.rr_min_p, *sky_constants(config)),
            wrapper=mega_step)
    return fs_out, is_out


mega_step.launches = 0


def octant_order(fstate: torch.Tensor) -> torch.Tensor:
    """The permutation that stably sorts the rays by the octant of their
    direction, dead rays last (key 8): the reference's 9-bucket counting
    sort (megakernel.py:613-635)."""
    key = ((fstate[3] > 0.0).to(torch.int64) * 4
           + (fstate[4] > 0.0).to(torch.int64) * 2
           + (fstate[5] > 0.0).to(torch.int64))
    key = torch.where(fstate[12] > 0.0, key, 8)
    return torch.argsort(key, stable=True)


def pack_state(ray: Ray, seed, far: float = 1000.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed (24, N) f32 and (8, N) i32 state of camera rays ``ray``
    with PCG2D words ``seed``, N padded to a multiple of 256 with dead
    rays: throughput 1, radiance 0, depth ``far``, prev pdf -1 (a camera
    ray is not a BRDF sample)."""
    n = ray.o.x.shape[0]
    n_pad = -(-n // BN) * BN
    dev = ray.o.x.device

    def pad(x, value=0.0):
        return torch.nn.functional.pad(x, (0, n_pad - n), value=value)

    ones = torch.ones(n, dtype=torch.float32, device=dev)
    zeros = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    fstate = torch.stack([
        pad(ray.o.x), pad(ray.o.y), pad(ray.o.z),
        pad(ray.d.x, 1.0), pad(ray.d.y, 1.0), pad(ray.d.z, 1.0),
        pad(ones), pad(ones), pad(ones), zeros, zeros, zeros,
        pad(ones), zeros + far, zeros - 1.0,
        *(zeros,) * (FS_R - 15)]).contiguous()
    istate = torch.zeros((IS_R, n_pad), dtype=torch.int32, device=dev)
    istate[0, :n] = _as_i32(seed[0].to(torch.int64) & _MASK32)
    istate[1, :n] = _as_i32(seed[1].to(torch.int64) & _MASK32)
    return fstate, istate


def path_trace_mega(scene: Scene, ray: Ray, seed, config: RenderConfig,
                    prep: TracePrep | None = None, far: float = 1000.0):
    """Trace one path per ray with :func:`mega_step`, one launch per bounce
    (port of ``path_trace_mega``; the same transport and PCG2D stream as
    render/integrator.py ``path_trace``). Returns a PathTraceResult."""
    from gdpathtracing_torch.render.integrator import PathTraceResult

    if prep is None:
        prep = prepare_trace_inputs(scene)
    if prep.superchunks:
        raise ValueError("MEGA takes flat scenes only (at most "
                         f"{MAX_MEGA_CHUNKS} chunks)")
    n = ray.o.x.shape[0]
    nee = config.nee and scene.n_lights > 0
    fstate, istate = pack_state(ray, seed, far)
    n_pad = fstate.shape[1]
    dev = fstate.device
    lt = _build_light_block(prep.lights if nee else None, dev)

    compact = config.compact_rays
    if compact is None:
        compact = n_pad >= 4 * BN
    src = torch.arange(n_pad, device=dev) if compact else None
    for b in range(config.bounces):
        if compact and b > 0:
            perm = octant_order(fstate)
            fstate = fstate.index_select(1, perm)
            istate = istate.index_select(1, perm)
            src = src.index_select(0, perm)
        fstate, istate = mega_step(fstate, istate, prep.bounds,
                                   prep.sub_bounds, prep.mu, prep.mv, prep.mw,
                                   prep.tab, lt, b, config)
    if compact:
        fstate = torch.empty_like(fstate).index_copy_(1, src, fstate)
        istate = torch.empty_like(istate).index_copy_(1, src, istate)

    return PathTraceResult(
        radiance=Vec3(fstate[9, :n], fstate[10, :n], fstate[11, :n]),
        depth=fstate[13, :n],
        steps=istate[2, :n],
        segments=istate[3, :n],
        normal=Vec3(fstate[15, :n], fstate[16, :n], fstate[17, :n]),
    )
