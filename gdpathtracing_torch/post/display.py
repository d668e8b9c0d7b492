"""Display transform: exposure, bloom, tonemap — port of
gdpathtracing_tpu/post/display.py."""

from __future__ import annotations

import torch

from gdpathtracing_torch.config import RenderConfig, Tonemap
from gdpathtracing_torch.post.tonemap import aces_film


def bloom(img: torch.Tensor, threshold: float, strength: float,
          radius: int) -> torch.Tensor:
    """Threshold the highlights, blur them with a separable Gaussian of
    ``2 * radius + 1`` taps (edge-padded), add them back."""
    bright = torch.clamp(img - threshold, min=0.0)
    sigma = max(radius / 2.0, 1e-3)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()

    def blur_axis(a, axis):
        n = a.shape[axis]
        idx = torch.clamp(torch.arange(-radius, n + radius, device=a.device),
                          0, n - 1)
        ap = a.index_select(axis, idx)
        out = torch.zeros_like(a)
        for i in range(2 * radius + 1):
            out = out + k[i] * ap.narrow(axis, i, n)
        return out

    return img + strength * blur_axis(blur_axis(bright, 0), 1)


def display_transform(linear: torch.Tensor,
                      config: RenderConfig) -> torch.Tensor:
    """(H, W, 3) linear radiance → display values in [0, 1]."""
    img = linear * config.exposure
    if config.bloom:
        img = bloom(img, config.bloom_threshold, config.bloom_strength,
                    config.bloom_radius)
    if config.tonemap == Tonemap.ACES:
        return aces_film(img)
    if config.tonemap == Tonemap.REINHARD:
        return torch.clamp(img / (1.0 + img), 0.0, 1.0)
    return torch.clamp(img, 0.0, 1.0)  # LINEAR
