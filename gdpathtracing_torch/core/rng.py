"""PCG2D counter-based RNG — bit-exact port of gdpathtracing_tpu/core/rng.py.

Torch has no full uint32 arithmetic, so each 32-bit state word is carried in
an int64 tensor holding a value in [0, 2^32) and masked with ``& 0xFFFFFFFF``
after every multiply and add. Products by the LCG multiplier stay below 2^53;
the golden-ratio multiplier is applied in 16-bit halves (``_mul32``) so no
product overflows int64.
Right shifts of a non-negative int64 are logical shifts, as on uint32. The
float conversion reads the masked int64, so values at or above 2^31 convert
as unsigned, exactly like the reference's uint32 → float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

_MASK = 0xFFFFFFFF
_A = 1664525
_C = 1013904223
_GOLDEN = 0x9E3779B9
_INV32 = 2.32830643654e-10  # 2^-32 as the reference writes it (f32-rounded)

Seed = Tuple[torch.Tensor, torch.Tensor]


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for a in [0, 2^32) without leaving int64: k is
    split in 16-bit halves so no partial product reaches 2^63."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg2d(seed: Seed):
    """One PCG2D step. Returns ((u, v) float32 in [0,1), new_seed)."""
    sx, sy = seed
    sx = (sx * _A + _C) & _MASK
    sy = (sy * _A + _C) & _MASK
    sx = (sx + sy * _A) & _MASK
    sy = (sy + sx * _A) & _MASK
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    sx = (sx + sy * _A) & _MASK
    sy = (sy + sx * _A) & _MASK
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    u = sx.to(torch.float32) * _INV32
    v = sy.to(torch.float32) * _INV32
    return (u, v), (sx, sy)


def prng_seed(px: torch.Tensor, py: torch.Tensor, frame) -> Seed:
    """Per-pixel seed hash. `px`, `py` are non-negative integer tensors,
    `frame` an int (or int tensor) taken modulo 2^32."""
    if isinstance(frame, torch.Tensor):
        frame = frame.to(torch.int64) & _MASK
    else:
        frame = int(frame) & _MASK
    sx = (_mul32(px.to(torch.int64) & _MASK, _GOLDEN) + frame) & _MASK
    sy = (_mul32(py.to(torch.int64) & _MASK, _GOLDEN) + frame) & _MASK
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    return _mul32(sx, _GOLDEN), _mul32(sy, _GOLDEN)
