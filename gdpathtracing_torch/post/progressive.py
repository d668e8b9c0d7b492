"""Progressive accumulation: unbounded averaging while the camera is still
— port of gdpathtracing_tpu/post/progressive.py.

The accumulator and frame count are an explicit state tuple, which is also
the checkpoint (post/checkpoint.py): save it, keep accumulating later. Full
precision radiance is accumulated (the reference's original accumulates the
quantised screen texture).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdpathtracing_torch.scene.scene import resolve_device


class ProgressiveState(NamedTuple):
    accum: torch.Tensor           # (H, W, 3) f32 radiance sum
    frame_count: torch.Tensor     # () i32
    prev_transform: torch.Tensor  # (3, 4) camera transform of last frame


def progressive_init(width: int, height: int,
                     device="cuda") -> ProgressiveState:
    """Empty state on ``device`` (the card unless the caller asks for
    another); the infinite previous transform makes the first update
    start afresh."""
    device = resolve_device(device)
    return ProgressiveState(
        accum=torch.zeros((height, width, 3), dtype=torch.float32,
                          device=device),
        frame_count=torch.zeros((), dtype=torch.int32, device=device),
        prev_transform=torch.full((3, 4), torch.inf, dtype=torch.float32,
                                  device=device))


def progressive_update(state: ProgressiveState, radiance: torch.Tensor,
                       cam_transform: torch.Tensor, eps: float = 1e-5):
    """Returns (linear averaged radiance (H, W, 3), new state). A camera
    that moved by more than ``eps`` in any entry resets the accumulator.
    The display transform is the caller's (post/display.py)."""
    moved = (torch.abs(state.prev_transform - cam_transform) > eps).any()
    count = torch.where(moved, 1, state.frame_count + 1).to(torch.int32)
    accum = torch.where(moved, radiance, state.accum + radiance)
    avg = accum / count.to(torch.float32)
    return avg, ProgressiveState(accum, count, cam_transform)
