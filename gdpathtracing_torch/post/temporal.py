"""Temporal reprojection: history blending for a moving camera — port of
gdpathtracing_tpu/post/temporal.py.

Each pixel's NDC position, with the reversed-Z non-linear depth, goes
through ``prev_vp @ inv(vp)`` to the previous frame; the nearest previous
pixel's history is taken where it lies in the image and its stored depth
matches within ``depth_eps``, and blended with the current radiance.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdpathtracing_torch.scene.scene import resolve_device


class TemporalState(NamedTuple):
    history: torch.Tensor      # (H, W, 3) f32 blended radiance history
    prev_depth: torch.Tensor   # (H, W) f32 reversed-Z depth of last frame
    prev_vp: torch.Tensor      # (4, 4)
    frame_count: torch.Tensor  # () i32


def temporal_init(width: int, height: int, device="cuda") -> TemporalState:
    """Empty state on ``device`` (the card unless the caller asks for
    another)."""
    device = resolve_device(device)
    return TemporalState(
        history=torch.zeros((height, width, 3), dtype=torch.float32,
                            device=device),
        prev_depth=torch.zeros((height, width), dtype=torch.float32,
                               device=device),
        prev_vp=torch.eye(4, dtype=torch.float32, device=device),
        frame_count=torch.zeros((), dtype=torch.int32, device=device))


def nonlinear_depth(linear_depth: torch.Tensor, near: float,
                    far: float) -> torch.Tensor:
    """The reversed-Z non-linear depth of a linear one."""
    near_t = torch.full_like(linear_depth, near)
    return far / (far - near) * (1.0 - near_t / linear_depth)


def temporal_update(state: TemporalState, radiance: torch.Tensor,
                    depth_nl: torch.Tensor, vp: torch.Tensor,
                    blend: float = 0.75, depth_eps: float = 0.1):
    """Returns (blended linear radiance (H, W, 3), new state). ``depth_nl``
    is the current frame's reversed-Z depth, ``vp`` its view-projection."""
    h, w = radiance.shape[:2]
    dev = radiance.device
    reproj = state.prev_vp @ torch.linalg.inv(vp)
    # Divide by tensors: CUDA torch turns a division by a Python scalar
    # into a multiply by its reciprocal, which rounds otherwise.
    wh = torch.tensor([float(w), float(h)], device=dev)
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / wh[0] \
        * 2.0 - 1.0
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / wh[1] \
        * -2.0 + 1.0
    ndc_x = xs[None, :].expand(h, w)
    ndc_y = ys[:, None].expand(h, w)
    px, py, pz, pw = (reproj[k, 0] * ndc_x + reproj[k, 1] * ndc_y
                      + reproj[k, 2] * depth_nl + reproj[k, 3]
                      for k in range(4))
    safe_w = torch.where(torch.abs(pw) < 1e-8, 1e-8, pw)
    px, py, pz = px / safe_w, py / safe_w, pz / safe_w

    # The nearest previous pixel.
    u = (px + 1.0) * 0.5
    v = (1.0 - py) * 0.5
    ix = torch.floor(u * w).to(torch.int64)
    iy = torch.floor(v * h).to(torch.int64)
    in_bounds = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    ixc = torch.clamp(ix, 0, w - 1)
    iyc = torch.clamp(iy, 0, h - 1)
    hist_color = state.history[iyc, ixc]
    hist_depth = state.prev_depth[iyc, ixc]
    accept = in_bounds & (torch.abs(hist_depth - pz) < depth_eps) \
        & (state.frame_count > 0)

    reprojected = torch.where(accept[..., None], hist_color, radiance)
    blended = radiance + (reprojected - radiance) * blend
    return blended, TemporalState(history=blended, prev_depth=depth_nl,
                                  prev_vp=vp,
                                  frame_count=state.frame_count + 1)
