"""Closest-hit traversal over the chunked expanded-triangle list.

Port of the flat (≤ 16 chunks) part of gdpathtracing_tpu/ops/intersect_pallas.py:
``build_trace_table``, ``_inflate_bounds``, ``prepare_trace_inputs`` and
``trace_pallas``, over kernel 1 of the TPU package (``_kernel_rows`` +
``_sweep_update``), here :func:`closest_hit_rows`:

- on a CUDA tensor it launches the hand-written kernel
  ``csrc/closest_hit_rows.cu`` (built by nvcc at first use, ops/build.py);
- on a CPU tensor it runs :func:`closest_hit_rows_plain`, the plain PyTorch
  version of the same contract, which the CPU tests hold against JAX and
  ``chip_smoke.py`` holds against the kernel on the card.

The TPU kernel visits chunks near-to-far from a per-block queue; the winner
does not depend on visit order, so both versions here walk the chunks in
index order (only the ``steps`` row sees the difference).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gdpathtracing_torch.render.types import MISS_T, HitInfo, Ray
from gdpathtracing_torch.scene.scene import Scene

BN = 256     # rays per kernel block
BT = 256     # triangles per chunk
TAB_R = 40   # winner-table rows
OUT_R = 48   # output rows: 0:40 table | 40 t | 41 u | 42 v | 43 w_d |
#              44 eidx | 45 triangles swept by the ray | 46 chunks swept
#              by its 256-ray block | 47 zero
MAX_FLAT_CHUNKS = 16  # larger scenes take the superchunk kernel (not ported)
_WD_EPS = 1e-12
_MISS = 1e9


def build_trace_table(scene: Scene) -> torch.Tensor:
    """(40, E) f32 per-expanded-triangle table:

      0:9   world shading normals n0, n1, n2
      9:15  uv0, uv1, uv2
      15    global triangle index (float-exact below 2^24)
      16    instance index
      17:30 material row [albedo3, emission3, energy, metallic, roughness,
            tex, transmission, ior, mr_tex]
      30    NEE pdf term pick_prob/area (0 = not an emitter)
      31:34 emitter geometric normal
      34:40 zero padding
    """
    from gdpathtracing_torch.render.lights import build_light_table

    shade = scene.isect_shade  # (E, 16)
    e = shade.shape[0]
    mat_id = shade[:, 15].to(torch.int64)
    mat_tbl = torch.cat([
        scene.mat_albedo, scene.mat_emission,
        scene.mat_emission_energy[:, None], scene.mat_metallic[:, None],
        scene.mat_roughness[:, None],
        scene.mat_tex.to(torch.float32)[:, None],
        scene.mat_transmission[:, None], scene.mat_ior[:, None],
        scene.mat_mr_tex.to(torch.float32)[:, None]], dim=1)  # (M, 13)
    mats = mat_tbl[mat_id]

    if scene.n_lights > 0:
        lt = build_light_table(scene)
        li = torch.clamp(scene.isect_light, 0, lt.area.shape[0] - 1).long()
        is_l = (scene.isect_light >= 0).to(torch.float32)
        inv_term = (lt.pick_prob[li] / torch.clamp(lt.area[li], min=1e-8)) \
            * is_l
        light_cols = torch.stack([inv_term, lt.normal.x[li] * is_l,
                                  lt.normal.y[li] * is_l,
                                  lt.normal.z[li] * is_l], dim=1)
    else:
        light_cols = shade.new_zeros((e, 4))

    tab = torch.cat([
        shade[:, 0:15],
        scene.isect_tri.to(torch.float32)[:, None],
        scene.isect_inst.to(torch.float32)[:, None],
        mats,
        light_cols,
        shade.new_zeros((e, TAB_R - 34)),
    ], dim=1)  # (E, 40)
    return tab.T.contiguous()


def _rcp(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(d) < 1e-30, 1e-30, d)


def _inflate_bounds(cb: torch.Tensor) -> torch.Tensor:
    """(8, nc) chunk bounds → copy inflated by ~100 ulp, so a ray whose
    triangle hit the sweep would find always passes its own slab test."""
    lo, hi, pad = cb[0:3], cb[3:6], cb[6:8]
    eps = 1e-5 * torch.maximum(torch.abs(lo), torch.abs(hi)) + 1e-6
    return torch.cat([lo - eps, hi + eps, pad], dim=0)


class TracePrep(NamedTuple):
    """Kernel-ready trace inputs, built once per scene."""
    mu: torch.Tensor      # (4, E)
    mv: torch.Tensor
    mw: torch.Tensor
    tab: torch.Tensor     # (40, E)
    bounds: torch.Tensor  # (8, nc) inflated chunk AABBs


def prepare_trace_inputs(scene: Scene) -> TracePrep:
    e = scene.isect_mu.shape[1]
    if e >= 2 ** 24:
        raise ValueError(f"scene has {e} expanded triangles; ids ride the "
                         f"f32 rows and are exact only below 2^24")
    nc = e // BT
    if nc > MAX_FLAT_CHUNKS:
        raise NotImplementedError(
            f"scene has {nc} chunks; scenes with more than "
            f"{MAX_FLAT_CHUNKS} need the superchunk kernels "
            f"(ROADMAP queue 1, item 8)")
    return TracePrep(scene.isect_mu.contiguous(), scene.isect_mv.contiguous(),
                     scene.isect_mw.contiguous(), build_trace_table(scene),
                     _inflate_bounds(scene.isect_chunk_bounds).contiguous())


# ---------------------------------------------------------------------------
# Kernel 1: closest hit + winner rows
# ---------------------------------------------------------------------------

def _check_inputs(o4t, d4t, bounds, mu, mv, mw, tab) -> tuple[int, int]:
    args = dict(o4t=o4t, d4t=d4t, bounds=bounds, mu=mu, mv=mv, mw=mw,
                tab=tab)
    dev = o4t.device
    for name, x in args.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, o4t on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = o4t.shape[1] if o4t.dim() == 2 else -1
    e = mu.shape[1] if mu.dim() == 2 else -1
    nc = e // BT
    want = dict(o4t=(4, n), d4t=(4, n), bounds=(8, nc), mu=(4, e),
                mv=(4, e), mw=(4, e), tab=(TAB_R, e))
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(args[name].shape)}, "
                             f"expected {shape}")
    if n <= 0 or n % BN or e <= 0 or e % BT:
        raise ValueError(f"need N % {BN} == 0 and E % {BT} == 0 "
                         f"(N={n}, E={e})")
    return n, e


def closest_hit_rows_plain(o4t, d4t, bounds, mu, mv, mw, tab) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract (see
    csrc/closest_hit_rows.cu): same chunk order, same per-ray gate, same
    term order in every dot product, elementwise products only (no matmul,
    so no TF32). Runs chunk by chunk and only on the rays whose slab test
    passed, so temporaries are (rays, 256), never (rays, E)."""
    n, e = o4t.shape[1], mu.shape[1]
    nc = e // BT
    ox, oy, oz, ow = o4t.unbind(0)
    dx, dy, dz, dw = d4t.unbind(0)
    rdx, rdy, rdz = _rcp(dx), _rcp(dy), _rcp(dz)
    best_t = torch.full((n,), _MISS, dtype=torch.float32, device=o4t.device)
    best_e = torch.zeros(n, dtype=torch.int64, device=o4t.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_wd = torch.zeros_like(best_t)
    steps = torch.zeros_like(best_t)
    sweeps = torch.zeros_like(best_t)

    lane = torch.arange(BT, device=o4t.device)

    def dot4(m, x0, x1, x2, x3):  # (4, BT) rows x (k,) rays → (k, BT)
        return x0[:, None] * m[0] + x1[:, None] * m[1] + \
            x2[:, None] * m[2] + x3[:, None] * m[3]

    for c in range(nc):
        b = bounds[:, c]
        tx1 = (b[0] - ox) * rdx
        tx2 = (b[3] - ox) * rdx
        ty1 = (b[1] - oy) * rdy
        ty2 = (b[4] - oy) * rdy
        tz1 = (b[2] - oz) * rdz
        tz2 = (b[5] - oz) * rdz
        tmin = torch.maximum(torch.maximum(torch.minimum(tx1, tx2),
                                           torch.minimum(ty1, ty2)),
                             torch.minimum(tz1, tz2))
        tmax = torch.minimum(torch.minimum(torch.maximum(tx1, tx2),
                                           torch.maximum(ty1, ty2)),
                             torch.maximum(tz1, tz2))
        may = (tmax >= tmin) & (tmax > 0.0) & (tmin <= best_t)
        sweeps += may.view(-1, BN).any(dim=1).repeat_interleave(BN).to(
            torch.float32)
        idx = torch.nonzero(may).squeeze(1)
        if idx.numel() == 0:
            continue
        steps[idx] += float(BT)
        cols = slice(c * BT, (c + 1) * BT)
        o = (ox[idx], oy[idx], oz[idx], ow[idx])
        d = (dx[idx], dy[idx], dz[idx], dw[idx])
        w_d = dot4(mw[:, cols], *d)
        w_o = dot4(mw[:, cols], *o)
        wd_ok = torch.abs(w_d) > _WD_EPS
        t = -w_o / torch.where(wd_ok, w_d, 1.0)
        u = dot4(mu[:, cols], *o) + t * dot4(mu[:, cols], *d)
        v = dot4(mv[:, cols], *o) + t * dot4(mv[:, cols], *d)
        valid = wd_ok & (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        t = torch.where(valid, t, _MISS)
        tk = torch.amin(t, dim=1)
        # Lowest index among equal minima (torch.min's index is not
        # guaranteed to be the first on every device).
        k = torch.where(t == tk[:, None], lane, BT).amin(dim=1)
        ek = k + c * BT
        cur_t, cur_e = best_t[idx], best_e[idx]
        better = (tk < cur_t) | ((tk == cur_t) & (tk < _MISS) & (ek < cur_e))
        sel, kb = idx[better], k[better][:, None]
        best_t[sel] = tk[better]
        best_e[sel] = ek[better]
        best_u[sel] = u[better].gather(1, kb)[:, 0]
        best_v[sel] = v[better].gather(1, kb)[:, 0]
        best_wd[sel] = w_d[better].gather(1, kb)[:, 0]

    hit = best_t < _MISS
    out = torch.empty((OUT_R, n), dtype=torch.float32, device=o4t.device)
    out[:TAB_R] = torch.where(hit, tab[:, best_e], 0.0)
    out[40], out[41], out[42], out[43] = best_t, best_u, best_v, best_wd
    out[44] = best_e.to(torch.float32)
    out[45], out[46] = steps, sweeps
    out[47] = 0.0
    return out


def _cuda_closest_hit_rows():
    from gdpathtracing_torch.ops.build import load_library

    fn = load_library("closest_hit_rows").lib.closest_hit_rows
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def closest_hit_rows(o4t, d4t, bounds, mu, mv, mw, tab) -> torch.Tensor:
    """(48, N) closest-hit rows for rays ``o4t``/``d4t`` (4, N) over the
    chunked triangles ``mu``/``mv``/``mw`` (4, E) with inflated chunk
    ``bounds`` (8, E/256) and winner table ``tab`` (40, E).

    CUDA tensors launch the kernel (and count the launch in
    ``closest_hit_rows.launches``); CPU tensors run the plain version.
    Anything else raises."""
    n, e = _check_inputs(o4t, d4t, bounds, mu, mv, mw, tab)
    if o4t.device.type == "cpu":
        return closest_hit_rows_plain(o4t, d4t, bounds, mu, mv, mw, tab)
    if o4t.device.type != "cuda":
        raise ValueError(f"no closest_hit_rows for device {o4t.device}")
    fn = _cuda_closest_hit_rows()
    out = torch.empty((OUT_R, n), dtype=torch.float32, device=o4t.device)
    stream = torch.cuda.current_stream(o4t.device).cuda_stream
    with torch.cuda.device(o4t.device):
        err = fn(o4t.data_ptr(), d4t.data_ptr(), bounds.data_ptr(),
                 mu.data_ptr(), mv.data_ptr(), mw.data_ptr(), tab.data_ptr(),
                 out.data_ptr(), n, e, stream)
    if err != 0:
        raise RuntimeError(f"closest_hit_rows kernel launch failed: "
                           f"cudaError {err}")
    closest_hit_rows.launches += 1
    return out


closest_hit_rows.launches = 0


# ---------------------------------------------------------------------------
# HitInfo wrapper
# ---------------------------------------------------------------------------

def pack_rays(ray: Ray, active=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(o4t, d4t), each (4, N padded to a multiple of 256): rays as (o, 1)
    and (d, 0). Dead rays (``active`` False) and the padding are parked far
    outside the scene pointing away, so every chunk slab test fails and
    they sweep nothing."""
    n = ray.o.x.shape[0]
    n_pad = -(-n // BN) * BN
    ox, oy, oz = ray.o.x, ray.o.y, ray.o.z
    dx, dy, dz = ray.d.x, ray.d.y, ray.d.z
    if active is not None:
        far, s3 = 1e9, 0.5773503
        ox = torch.where(active, ox, far)
        oy = torch.where(active, oy, far)
        oz = torch.where(active, oz, far)
        dx = torch.where(active, dx, s3)
        dy = torch.where(active, dy, s3)
        dz = torch.where(active, dz, s3)

    def pad(x, value=0.0):
        return torch.nn.functional.pad(x, (0, n_pad - n), value=value)

    o4t = torch.stack([pad(ox, 1e9), pad(oy, 1e9), pad(oz, 1e9),
                       pad(torch.ones_like(ox))])
    d4t = torch.stack([pad(dx, 1.0), pad(dy, 1.0), pad(dz, 1.0),
                       pad(torch.zeros_like(dx))])
    return o4t, d4t


def trace_pallas(scene: Scene, ray: Ray, active=None,
                 prep: TracePrep | None = None) -> HitInfo:
    """Closest hit for a wavefront (port of ``trace_pallas``): parks dead
    rays, pads to a multiple of 256, runs :func:`closest_hit_rows` and
    unpacks the rows. The returned HitInfo carries ``rows`` for
    render/shading.py ``shading_from_rows``."""
    n = ray.o.x.shape[0]
    o4t, d4t = pack_rays(ray, active)
    if prep is None:
        prep = prepare_trace_inputs(scene)
    rows = closest_hit_rows(o4t, d4t, prep.bounds, prep.mu, prep.mv,
                            prep.mw, prep.tab)[:, :n]

    t = rows[40]
    if active is not None:
        t = torch.where(active, t, MISS_T)
    return HitInfo(t=t,
                   tri=rows[15].to(torch.int32),
                   inst=rows[16].to(torch.int32),
                   u=torch.clamp(rows[41], 0.0, 1.0),
                   v=torch.clamp(rows[42], 0.0, 1.0),
                   front=rows[43] < 0.0,
                   steps=rows[45].to(torch.int32),
                   eidx=rows[44].to(torch.int32),
                   rows=rows)

