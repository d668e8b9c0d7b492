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

    def rcp_d(self) -> Vec3:
        """1/d, unguarded: a zero component gives inf (as in the
        reference, whose slab test then yields NaN on a box plane)."""
        return Vec3(1.0 / self.d.x, 1.0 / self.d.y, 1.0 / self.d.z)

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

    @classmethod
    def none(cls, shape, device=None) -> "HitInfo":
        """Miss record of ``shape``: t = MISS_T, eidx = -1 (the backend
        tracks no expanded-triangle index), everything else zero."""
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        zi = torch.zeros(shape, dtype=torch.int32, device=device)
        return cls(t=z + MISS_T, tri=zi, inst=zi, u=z, v=z,
                   front=torch.zeros(shape, dtype=torch.bool, device=device),
                   steps=zi, eidx=zi - 1)

    @classmethod
    def none_like(cls, ref: torch.Tensor) -> "HitInfo":
        """Miss record of ``ref``'s shape on its device."""
        return cls.none(ref.shape, ref.device)

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
