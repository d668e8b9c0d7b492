"""Edge-aware à-trous wavelet denoiser — port of
gdpathtracing_tpu/post/denoise.py.

Repeated 5×5 B3-spline cross-bilateral passes with a doubling hole size,
weighted by colour, normal and depth differences from the frame AOVs.
Plain torch, differentiable.
"""

from __future__ import annotations

import torch

_KERNEL_1D = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)
_OFFSETS = (-2, -1, 0, 1, 2)


def _shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``a`` rolled by (dy, dx) over its first two dimensions, with the
    reference's edge fill: the rows (columns) rolled in are overwritten by
    the first one that was not (its row index clamped into range, as the
    reference's gather clamps)."""
    if dy:
        a = torch.roll(a, dy, dims=0)
        h = a.shape[0]
        if dy > 0:
            a[:dy] = a[min(dy, h - 1)].clone()
        else:
            a[dy:] = a[max(dy - 1, -h)].clone()
    if dx:
        a = torch.roll(a, dx, dims=1)
        if dx > 0:
            a[:, :dx] = a[:, dx:dx + 1].clone()
        else:
            a[:, dx:] = a[:, dx - 1:dx].clone()
    return a


def atrous_denoise(color: torch.Tensor, normal: torch.Tensor,
                   depth: torch.Tensor, iterations: int = 3,
                   sigma_color: float = 0.5, sigma_normal: float = 0.25,
                   sigma_depth: float = 0.5) -> torch.Tensor:
    """(H, W, 3) linear colour + (H, W, 3) normals + (H, W) depth →
    denoised colour."""
    out = color
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2], dtype=out.dtype, device=out.device)
        for iy, oy in enumerate(_OFFSETS):
            for ix, ox in enumerate(_OFFSETS):
                w_k = _KERNEL_1D[iy] * _KERNEL_1D[ix]  # exact in f32
                dy, dx = oy * step, ox * step
                c = _shift2d(out, dy, dx)
                n = _shift2d(normal, dy, dx)
                d = _shift2d(depth, dy, dx)
                dc = ((c - out) ** 2).sum(dim=-1)
                w_c = torch.exp(-dc / (sigma_color ** 2))
                dn = ((n - normal) ** 2).sum(dim=-1)
                w_n = torch.exp(-dn / (sigma_normal ** 2))
                dd = (d - depth) ** 2
                w_d = torch.exp(-dd / (sigma_depth ** 2))
                w = w_k * w_c * w_n * w_d
                acc = acc + c * w[..., None]
                wsum = wsum + w
        out = acc / torch.clamp(wsum, min=1e-8)[..., None]
    return out
