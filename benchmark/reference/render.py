"""The reference renderer: one path per pixel through a closest-hit BVH
traversal, BRDF importance sampling and the sky on a miss, for a fixed
number of bounces (the upstream path loop, main.glsl:372-401), and the
inverse-rendering step that differentiates it with respect to the
material albedo table.

``lowp=True`` is the control: the same renderer with the path state (ray
origins and directions, throughput, radiance) rounded to bfloat16 after
every bounce, the nearest precision below the float32 the configurations
state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import bvh as bvh_mod
from benchmark.reference.scene import Description, Tables, compile_tables
from benchmark.reference.transport import (MISS_T, Camera, Vec3, brdf_pdf,
                                           eval_brdf, pcg2d, primary_rays,
                                           sample_brdf, shade, sky, vwhere)

TILE = 1 << 21  # rays a tile (a 1080p frame): bounds the traversal's stacks


class RefScene(NamedTuple):
    tables: Tables
    bvh: bvh_mod.BVH
    camera: Camera


class Counts(NamedTuple):
    """Work the reference's traversal needed for one frame."""
    segments: int   # rays traced
    boxes: int      # ray-box tests
    tris: int       # ray-triangle tests


def prepare(desc: Description, transform: np.ndarray, fov_deg: float,
            width: int, height: int, device) -> RefScene:
    tables = compile_tables(desc, device)
    cam = Camera(torch.as_tensor(transform, dtype=torch.float32,
                                 device=device),
                 torch.as_tensor(fov_deg, dtype=torch.float32, device=device),
                 width, height)
    return RefScene(tables, bvh_mod.build(tables.lo, tables.hi), cam)


def _bf16(v: Vec3) -> Vec3:
    return v.map(lambda x: x.to(torch.bfloat16).to(torch.float32))


def _trace_tile(ref: RefScene, pids, frame: int, albedo, bounces: int,
                ray_eps: float, lowp: bool, counts: list):
    tab = ref.tables
    o, d, seed = primary_rays(ref.camera, pids, frame)
    n = pids.shape[0]
    zero = torch.zeros(n, device=pids.device)
    tp = Vec3(zero + 1.0, zero + 1.0, zero + 1.0)
    rad = Vec3(zero, zero, zero)
    active = torch.ones(n, dtype=torch.bool, device=pids.device)
    for _ in range(bounces):
        hits = bvh_mod.closest_hit(ref.bvh, tab.cols, o.stack().detach(),
                                   d.stack().detach(), active)
        counts[0] += int(active.sum())
        counts[1] += int(hits.boxes.sum())
        counts[2] += int(hits.tris.sum())
        t = torch.where(active, hits.t, MISS_T)
        is_hit = (t < MISS_T) & active
        mat = tab.mat[hits.e]
        s = shade(tab.normals[hits.e], tab.mat_rows[mat], albedo[mat], o, d,
                  t, torch.clamp(hits.u, 0.0, 1.0),
                  torch.clamp(hits.v, 0.0, 1.0), hits.w_d < 0.0)
        emission = vwhere(is_hit, s.emission, sky(d))
        rad = vwhere(active, rad + tp * emission, rad)
        (r1, r2), seed = pcg2d(seed)
        new_dir = sample_brdf(s, r1, r2).map(torch.Tensor.detach)
        pdf = brdf_pdf(s, new_dir).detach()
        lambert_in = s.normal.dot(new_dir)
        f = eval_brdf(s, new_dir)
        scale = torch.where(pdf > 1e-12,
                            lambert_in / torch.clamp(pdf, min=1e-12), 0.0)
        survive = is_hit & (lambert_in > 0.0) & (pdf > 1e-12)
        new_o = s.position + s.normal * ray_eps
        new_tp = tp * (f * scale)
        o = vwhere(survive, new_o, o)
        d = vwhere(survive, new_dir, d)
        tp = vwhere(survive, new_tp, tp)
        active = survive
        if lowp:
            o, d, tp, rad = _bf16(o), _bf16(d), _bf16(tp), _bf16(rad)
    return rad.stack()


def render(ref: RefScene, frame: int, albedo: torch.Tensor | None = None,
           bounces: int = 5, ray_eps: float = 1e-3, lowp: bool = False):
    """(radiance (H, W, 3), Counts) of frame ``frame``, 1 sample a pixel.
    ``albedo`` (M, 3) replaces the scene's albedo table; autograd reaches
    it when it requires grad."""
    cam = ref.camera
    n = cam.width * cam.height
    dev = cam.transform.device
    albedo = ref.tables.albedo if albedo is None else albedo
    counts = [0, 0, 0]
    out = [_trace_tile(ref, torch.arange(k, min(k + TILE, n), device=dev),
                       frame, albedo, bounces, ray_eps, lowp, counts)
           for k in range(0, n, TILE)]
    return (torch.cat(out).reshape(cam.height, cam.width, 3),
            Counts(*counts))


def inverse_steps(ref: RefScene, albedo0: torch.Tensor,
                  target: torch.Tensor, frames, lr: float,
                  betas=(0.9, 0.999), eps: float = 1e-8, lowp: bool = False,
                  pixels=None):
    """The inverse-rendering loop from ``albedo0``: for each frame index,
    the image MSE against ``target``, its gradient with respect to the
    albedo table, and an Adam step projected onto [0, 1]. ``pixels``, when
    given, maps (image, target) to what the loss is taken over (the
    controls plant faults there). Returns (losses, first gradient, albedo
    after the steps, Counts of each render)."""
    p = albedo0.detach().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    losses, counts, g1 = [], [], None
    for k, frame in enumerate(frames, start=1):
        a = p.clone().requires_grad_(True)
        x, c = render(ref, frame, albedo=a, lowp=lowp)
        x, t = (x, target) if pixels is None else pixels(x, target)
        loss = torch.mean((x - t) ** 2)
        (g,) = torch.autograd.grad(loss, [a])
        losses.append(float(loss.detach()))
        counts.append(c)
        g1 = g.clone() if g1 is None else g1
        m = betas[0] * m + (1 - betas[0]) * g
        v = betas[1] * v + (1 - betas[1]) * g * g
        m_hat = m / (1 - betas[0] ** k)
        v_hat = v / (1 - betas[1] ** k)
        p = torch.clamp(p - lr * m_hat / (torch.sqrt(v_hat) + eps), 0.0, 1.0)
    return losses, g1, p, counts
