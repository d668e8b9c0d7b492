"""Sky radiance: analytic gradient or an equirect HDRI environment map.

Port of gdpathtracing_tpu/render/sky.py.
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.core.vec import Vec3, lerp

PI = 3.141592653589793


def sample_sky(direction: Vec3, config: RenderConfig, scene=None) -> Vec3:
    if scene is not None and getattr(scene, "has_env", False):
        return sample_environment(scene.env_map, direction) * \
            scene.env_energy
    t = 0.5 * (direction.y + 1.0)
    return lerp(Vec3(*config.sky_horizon), Vec3(*config.sky_zenith), t)


def sample_environment(env: torch.Tensor, d: Vec3) -> Vec3:
    """Bilinear equirect lookup: u from atan2(x, -z), v from acos(y)."""
    h, w = env.shape[0], env.shape[1]
    u = torch.atan2(d.x, -d.z) / (2.0 * PI) + 0.5
    v = torch.acos(torch.clamp(d.y, -1.0, 1.0)) / PI
    fu = u * w - 0.5
    fv = v * h - 0.5
    x0 = torch.floor(fu).to(torch.int64)
    y0 = torch.floor(fv).to(torch.int64)
    fx = fu - x0
    fy = fv - y0
    x0w = x0 % w
    x1w = (x0 + 1) % w
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)

    def fetch(yy, xx):
        c = env[yy, xx]
        return Vec3(c[..., 0], c[..., 1], c[..., 2])

    top = fetch(y0c, x0w) + (fetch(y0c, x1w) - fetch(y0c, x0w)) * fx
    bot = fetch(y1c, x0w) + (fetch(y1c, x1w) - fetch(y1c, x0w)) * fx
    return top + (bot - top) * fy
