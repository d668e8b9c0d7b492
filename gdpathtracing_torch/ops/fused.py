"""All-bounces path-tracing kernel (``Traversal.FUSED``) — port of
gdpathtracing_tpu/ops/fused_pallas.py.

One launch traces every bounce of every path of a wavefront: closest hit,
the winner's (E, 32) row, material, shading, sky and BRDF sampling, with the
path state kept in registers across the bounces.

The wrapper :func:`fused_paths`

- on a CUDA tensor launches kernel 11 (``csrc/fused_paths.cu``, built by
  nvcc at first use) and counts the launch in ``fused_paths.launches``;
- on a CPU tensor runs :func:`fused_paths_plain`, the bounce loop over
  kernel 1's plain walk (``walk_flat_plain``) and the port's shading, sky
  and BRDF modules, which the CPU tests hold against JAX.

FUSED keeps the reference's own shading rules, which differ from MEGA's and
PALLAS's: u and v from the winner's ``isect_cols`` at its t, not clipped;
transmission 0 and ior 1.5; depth = t at the first hit; no sample after the
last bounce; ``steps`` = segments × E. The walk is flat (no superchunk
level) for up to 64 chunks. Where the reference gated whole blocks on the
raw chunk boxes with a strict ``tmin < best``, the port gates each ray on
the inflated boxes (kernel 1's walk), whose winner does not depend on the
block.

Scope (``fused_supported``): no NEE, environment map, transmission or
Russian roulette, only the dummy texture slot, E <= 16384.
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3, where as vwhere
from gdpathtracing_torch.ops.intersect import (BN, BT, MAT_W, TABLE_W,
                                               TracePrep, _FAR, _S3,
                                               _check_inputs, _launch, _MISS,
                                               prepare_trace_inputs,
                                               walk_flat_plain)
from gdpathtracing_torch.ops.megakernel import (_MASK32, _as_i32,
                                                sky_constants)
from gdpathtracing_torch.render import brdf
from gdpathtracing_torch.render.shading import MIN_ROUGHNESS, _finish
from gdpathtracing_torch.render.sky import sample_sky
from gdpathtracing_torch.render.types import Ray
from gdpathtracing_torch.scene.scene import Scene

MAX_FUSED_TRIS = 16384


def fused_supported(scene: Scene, config: RenderConfig) -> bool:
    """The reference's gate for ``Traversal.FUSED``."""
    return (not config.nee and not scene.has_env
            and not scene.has_transmission
            and config.rr_start == 0
            and scene.textures.shape[0] == 1  # the dummy slot only
            and scene.isect_mu.shape[1] <= MAX_FUSED_TRIS
            and scene.mat_tex is not None)


def _build_table(scene: Scene) -> torch.Tensor:
    """(E, 32) combined rows: ``isect_cols`` (12) | ``isect_shade`` (16:
    n0, n1, n2, uvs, mat) | 4 zeros."""
    e = scene.isect_cols.shape[0]
    return torch.cat([scene.isect_cols, scene.isect_shade,
                      scene.isect_cols.new_zeros((e, TABLE_W - 28))],
                     dim=1).contiguous()


def _build_mats(scene: Scene) -> torch.Tensor:
    """(M, 16) material rows: albedo3 | emission3 | energy | metallic |
    roughness | tex | transmission | ior | mr_tex | 3 zeros."""
    m = torch.cat([
        scene.mat_albedo, scene.mat_emission,
        scene.mat_emission_energy[:, None], scene.mat_metallic[:, None],
        scene.mat_roughness[:, None],
        scene.mat_tex.to(torch.float32)[:, None],
        scene.mat_transmission[:, None], scene.mat_ior[:, None],
        scene.mat_mr_tex.to(torch.float32)[:, None]], dim=1)
    return torch.nn.functional.pad(m, (0, MAT_W - m.shape[1])).contiguous()


def fused_paths_plain(o4t, d4t, seeds, bounds, mu, mv, mw, table, mats,
                      config: RenderConfig, counts: dict | None = None):
    """Plain PyTorch version of csrc/fused_paths.cu: ``config.bounces``
    bounces of each ray, each a :func:`walk_flat_plain` closest hit and the
    reference's FUSED shading (fused_pallas.py:200-297). Returns ((7, N)
    f32 radiance rgb | depth (1e9 on a miss) | first-hit normal, (N,) i32
    segments). A ``counts`` dict receives, summed over the bounces,
    ``tests``, the ray-triangle tests these inputs need, ``slots``, the
    thread-slots kernel 11's block-cooperative walk spends on them
    (``walk_flat_plain``), and ``thread_slots``, those a thread per ray
    would (every lane of a block sweeps each chunk some ray of it needs)."""
    n = o4t.shape[1]
    o = Vec3(o4t[0], o4t[1], o4t[2])
    d = Vec3(d4t[0], d4t[1], d4t[2])
    seed = (seeds[0].to(torch.int64) & _MASK32,
            seeds[1].to(torch.int64) & _MASK32)
    one_n = torch.ones(n, dtype=torch.float32, device=o4t.device)
    zero_n = one_n * 0.0
    tp = Vec3(one_n, one_n, one_n)
    rad = Vec3(zero_n, zero_n, zero_n)
    n0 = Vec3(zero_n, zero_n, zero_n)
    active = one_n > 0.0
    depth = zero_n + _MISS
    segs = torch.zeros(n, dtype=torch.int32, device=o4t.device)

    for bounce in range(config.bounces):
        walk, sweeps, slots = walk_flat_plain(
            torch.stack([*o, one_n]), torch.stack([*d, zero_n]), bounds, mu,
            mv, mw)
        t = walk.best_t
        hit = (t < _MISS) & active
        segs = segs + active.to(torch.int32)
        if counts is not None:
            for k, v in (("tests", walk.steps.sum()),
                         ("slots", slots[::BN].sum()),
                         ("thread_slots", sweeps[::BN].sum() * BN * BT)):
                counts[k] = counts.get(k, 0.0) + float(v)

        row = torch.where(hit[:, None], table.index_select(0, walk.best_e),
                          0.0)

        def dot4(c, x, y, z, w):
            return row[:, c] * x + row[:, c + 1] * y + row[:, c + 2] * z + \
                row[:, c + 3] * w

        u = dot4(0, o.x, o.y, o.z, one_n) + t * dot4(0, d.x, d.y, d.z, zero_n)
        v = dot4(4, o.x, o.y, o.z, one_n) + t * dot4(4, d.x, d.y, d.z, zero_n)
        front = dot4(8, d.x, d.y, d.z, zero_n) < 0.0
        w_bc = 1.0 - u - v
        normal = Vec3(
            row[:, 12] * w_bc + row[:, 15] * u + row[:, 18] * v,
            row[:, 13] * w_bc + row[:, 16] * u + row[:, 19] * v,
            row[:, 14] * w_bc + row[:, 17] * u + row[:, 20] * v,
        ).normalize(eps=1e-20)
        normal = vwhere(front, normal, -normal)

        m = mats.index_select(0, row[:, 27].to(torch.int64))
        albedo = Vec3(m[:, 0], m[:, 1], m[:, 2])
        energy = torch.clamp(m[:, 6], min=0.0)
        emission = Vec3(m[:, 3] * energy, m[:, 4] * energy, m[:, 5] * energy)
        s = _finish(Ray(o, d), t, normal, albedo, emission, m[:, 7],
                    torch.clamp(m[:, 8], min=MIN_ROUGHNESS), zero_n,
                    zero_n + 1.5)

        emit = vwhere(hit, s.emission, sample_sky(d, config))
        rad = vwhere(active, rad + tp * emit, rad)
        if bounce == 0:
            depth = torch.where(hit, t, depth)
            n0 = vwhere(hit, normal, n0)

        if bounce < config.bounces - 1:
            (r1, r2), seed = rng.pcg2d(seed)
            new_dir = brdf.sample_brdf(s, r1, r2)
            pdf = brdf.brdf_pdf(s, new_dir)
            lambert_in = s.normal.dot(new_dir)
            f = brdf.eval_brdf(s, new_dir)
            scale = torch.where(pdf > 1e-12,
                                lambert_in / torch.clamp(pdf, min=1e-12), 0.0)
            survive = hit & (lambert_in > 0.0) & (pdf > 1e-12)
            o = vwhere(survive, s.position + normal * config.ray_eps, o)
            d = vwhere(survive, new_dir, d)
            tp = Vec3(*(torch.where(survive, a * b * scale, a)
                        for a, b in zip(tp, f)))
            active = survive
            # Dead rays park far out, pointing away: every slab test fails.
            o = Vec3(*(torch.where(active, c, _FAR) for c in o))
            d = Vec3(*(torch.where(active, c, _S3) for c in d))

    out = torch.stack([rad.x, rad.y, rad.z, depth, n0.x, n0.y, n0.z])
    return out, segs


@torch.no_grad()
def fused_paths(o4t, d4t, seeds, bounds, mu, mv, mw, table, mats,
                config: RenderConfig):
    """Trace ``config.bounces`` bounces of the rays ``o4t``/``d4t`` (4, N)
    with PCG2D words ``seeds`` (2, N) i32 over the flat chunked triangles
    (inflated chunk ``bounds`` (8, nc), ``mu``/``mv``/``mw`` (4, E)), the
    (E, 32) ``table`` and the (M, 16) ``mats``. Returns ((7, N) f32
    radiance rgb | depth (1e9 on a miss) | first-hit normal, (N,) i32
    segments).

    CUDA tensors launch kernel 11 (counted in ``fused_paths.launches``);
    CPU tensors run :func:`fused_paths_plain`. Anything else raises."""
    n, e = _check_inputs(o4t=o4t, d4t=d4t, seeds=seeds, bounds=bounds,
                         mu=mu, mv=mv, mw=mw, table=table, mats=mats)
    if e > MAX_FUSED_TRIS or config.bounces < 1:
        raise ValueError(f"fused_paths needs at least one bounce and at most "
                         f"{MAX_FUSED_TRIS} triangles (E={e}, "
                         f"bounces={config.bounces})")
    if o4t.device.type == "cpu":
        return fused_paths_plain(o4t, d4t, seeds, bounds, mu, mv, mw, table,
                                 mats, config)
    out = torch.empty((7, n), dtype=torch.float32, device=o4t.device)
    segs = torch.empty(n, dtype=torch.int32, device=o4t.device)
    _launch("fused_paths", (o4t, d4t, seeds, bounds, mu, mv, mw, table, mats,
                            out, segs),
            n, e, int(config.bounces),
            floats=(config.ray_eps, *sky_constants(config)),
            wrapper=fused_paths)
    return out, segs


fused_paths.launches = 0


def pack_paths(ray: Ray, seed):
    """(o4t, d4t, seeds) of camera rays ``ray`` with PCG2D words ``seed``:
    (4, N) rays as (o, 1) and (d, 0) and (2, N) i32 words, N padded to a
    multiple of 256 with rays parked at 1e9 (the reference's padding)."""
    n = ray.o.x.shape[0]
    n_pad = -(-n // BN) * BN

    def pad(x, value=0.0):
        return torch.nn.functional.pad(x, (0, n_pad - n), value=value)

    o4t = torch.stack([pad(ray.o.x, _FAR), pad(ray.o.y, _FAR),
                       pad(ray.o.z, _FAR), pad(torch.ones_like(ray.o.x))])
    d4t = torch.stack([pad(ray.d.x, 1.0), pad(ray.d.y, 1.0),
                       pad(ray.d.z, 1.0), pad(torch.zeros_like(ray.d.x))])
    seeds = torch.stack([pad(_as_i32(seed[0].to(torch.int64) & _MASK32)),
                         pad(_as_i32(seed[1].to(torch.int64) & _MASK32))])
    return o4t, d4t, seeds


def path_trace_fused(scene: Scene, ray: Ray, seed, config: RenderConfig,
                     prep: TracePrep | None = None, far: float = 1000.0):
    """Trace one path per ray with one :func:`fused_paths` launch (port of
    ``path_trace_fused``). Returns a PathTraceResult."""
    from gdpathtracing_torch.render.integrator import PathTraceResult

    if prep is None:
        prep = prepare_trace_inputs(scene)
    n = ray.o.x.shape[0]
    o4t, d4t, seeds = pack_paths(ray, seed)
    scene = scene.detach()
    out, segs = fused_paths(o4t, d4t, seeds, prep.bounds,
                            prep.mu, prep.mv, prep.mw, _build_table(scene),
                            _build_mats(scene), config)
    depth = out[3, :n]
    return PathTraceResult(
        radiance=Vec3(out[0, :n], out[1, :n], out[2, :n]),
        depth=torch.where(depth >= _MISS, far, depth),
        steps=segs[:n] * scene.isect_mu.shape[1],
        segments=segs[:n],
        normal=Vec3(out[4, :n], out[5, :n], out[6, :n]),
    )
