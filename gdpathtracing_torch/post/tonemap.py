"""ACES filmic tonemap (Narkowicz approximation) — port of
gdpathtracing_tpu/post/tonemap.py."""

from __future__ import annotations

import torch


def aces_film(x: torch.Tensor) -> torch.Tensor:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
