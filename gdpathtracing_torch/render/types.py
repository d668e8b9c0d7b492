"""SoA ray/hit/shading records — port of gdpathtracing_tpu/render/types.py.

One record is the whole wavefront: every field is an ``(N,)`` tensor (or a
:class:`Vec3` of them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdpathtracing_torch.core.vec import Vec3


class Ray(NamedTuple):
    o: Vec3
    d: Vec3

    def at(self, t) -> Vec3:
        return self.o + self.d * t

    def detach(self) -> "Ray":
        return Ray(self.o.detach(), self.d.detach())


MISS_T = 1e9  # float32-exact miss distance


class HitInfo(NamedTuple):
    """Closest-hit record (t in instance-invariant units)."""

    t: torch.Tensor       # f32, MISS_T = miss
    tri: torch.Tensor     # i32 triangle index (global pool)
    inst: torch.Tensor    # i32 BLAS-instance index
    u: torch.Tensor       # f32 barycentric
    v: torch.Tensor       # f32 barycentric
    front: torch.Tensor   # bool — geometric normal faces the ray
    steps: torch.Tensor   # i32 — triangle tests
    eidx: torch.Tensor    # i32 — expanded-triangle index
    rows: torch.Tensor | None = None  # (48, N) packed winner rows
    #                       (ops/intersect.py build_trace_table layout)

    @property
    def hit(self) -> torch.Tensor:
        return self.t < MISS_T


class ShadingInfo(NamedTuple):
    position: Vec3
    normal: Vec3
    out_dir: Vec3
    lambert_out: torch.Tensor
    emission: Vec3
    diffuse_albedo: Vec3
    fresnel_0: Vec3
    roughness: torch.Tensor
    transmission: torch.Tensor  # dielectric transparency in [0, 1]
    ior: torch.Tensor
    albedo: Vec3                # untinted base color (transmission tint)
