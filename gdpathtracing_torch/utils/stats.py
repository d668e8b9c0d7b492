"""Per-frame render statistics and the traversal-cost view — port of
gdpathtracing_tpu/utils/stats.py."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdpathtracing_torch.render.renderer import FrameAOVs


class FrameStats(NamedTuple):
    rays: int                # traced path segments
    mean_path_length: float  # segments / pixel / spp
    mean_tri_tests: float    # intersection tests per segment
    mrays_per_s: float       # needs the elapsed seconds

    def as_dict(self) -> dict:
        return self._asdict()


def frame_stats(aovs: FrameAOVs, spp: int = 1,
                elapsed_s: float | None = None) -> FrameStats:
    segments = int(aovs.segments.to(torch.int64).sum())
    steps = float(aovs.steps.to(torch.float64).sum())
    n_pix = aovs.segments.numel()
    return FrameStats(
        rays=segments,
        mean_path_length=segments / max(n_pix * spp, 1),
        mean_tri_tests=steps / max(segments, 1),
        mrays_per_s=(segments / elapsed_s / 1e6) if elapsed_s else 0.0)


def steps_heatmap(aovs: FrameAOVs, scale: float = 256.0) -> torch.Tensor:
    """Grey-scale traversal cost in [0, 1], (H, W, 3), clamped at
    ``scale`` triangle tests."""
    v = torch.clamp(aovs.steps.to(torch.float32) / scale, 0.0, 1.0)
    return torch.stack([v, v, v], dim=-1)
