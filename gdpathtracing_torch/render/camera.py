"""Camera: pose, intrinsics and primary-ray generation.

Port of gdpathtracing_tpu/render/camera.py: ``generate_rays`` and the
matrices ``projection``, ``view``, ``vp`` and ``ivp`` (the temporal
reprojection reads ``vp``). The pinhole unprojection is written out term
by term in float32 — no matrix product, so TF32 cannot enter — in the same
order as the JAX version; the matrices are built from the camera's tensors
with stack, so they are differentiable with respect to transform and FOV.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gdpathtracing_torch.config import Jitter, RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.math3d import look_at
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.render.types import Ray

_TWO_PI = 6.2831853


@dataclasses.dataclass(frozen=True)
class Camera:
    """World-from-camera affine (3, 4) + vertical FOV; camera looks down -Z.
    Resolution and near/far are plain metadata."""

    transform: torch.Tensor          # (3, 4) f32
    fov_deg: torch.Tensor            # () f32
    width: int = 640
    height: int = 360
    near: float = 0.01
    far: float = 1000.0

    @classmethod
    def from_affine(cls, transform, fov_deg: float, width: int, height: int,
                    near: float = 0.01, far: float = 1000.0,
                    device=None) -> "Camera":
        return cls(torch.as_tensor(transform, dtype=torch.float32,
                                   device=device),
                   torch.as_tensor(fov_deg, dtype=torch.float32,
                                   device=device),
                   width, height, near, far)

    @classmethod
    def looking_at(cls, eye, target, up=(0.0, 1.0, 0.0), *, fov_deg: float,
                   width: int, height: int, near: float = 0.01,
                   far: float = 1000.0, device=None) -> "Camera":
        return cls.from_affine(look_at(eye, target, up), fov_deg,
                               width, height, near, far, device=device)

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, transform=self.transform.to(device),
                                   fov_deg=self.fov_deg.to(device))

    @property
    def position(self) -> Vec3:
        return Vec3(self.transform[0, 3], self.transform[1, 3],
                    self.transform[2, 3])

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def half_tan(self) -> torch.Tensor:
        """tan of the float32 half-angle, evaluated in float64 and rounded:
        the correctly rounded float32 value on every device."""
        return torch.tan((self.fov_deg * (math.pi / 180.0) * 0.5)
                         .double()).float()

    def projection(self) -> torch.Tensor:
        """(4, 4) GL-style perspective (core/math3d.py ``perspective``)."""
        f = 1.0 / self.half_tan()
        n, fa = self.near, self.far
        zero, one = torch.zeros_like(f), torch.ones_like(f)
        return torch.stack([
            torch.stack([f / self.aspect, zero, zero, zero]),
            torch.stack([zero, f, zero, zero]),
            torch.stack([zero, zero, (fa + n) / (n - fa) * one,
                         2 * fa * n / (n - fa) * one]),
            torch.stack([zero, zero, -one, zero])])

    def view(self) -> torch.Tensor:
        """(4, 4) camera-from-world: the affine inverse of ``transform``."""
        r_inv = torch.linalg.inv(self.transform[:, :3])
        top = torch.cat([r_inv, -(r_inv @ self.transform[:, 3:])], dim=1)
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]],
                              device=self.transform.device)
        return torch.cat([top, bottom])

    def vp(self) -> torch.Tensor:
        """(4, 4) view-projection, ``projection() @ view()``."""
        return self.projection() @ self.view()

    def ivp(self) -> torch.Tensor:
        """(4, 4) inverse view-projection in closed form (world-from-camera
        times the inverse perspective), which avoids inverting the badly
        conditioned ``vp``."""
        f = 1.0 / self.half_tan()
        n, fa = self.near, self.far
        a = (fa + n) / (n - fa)
        b = 2.0 * fa * n / (n - fa)
        zero, one = torch.zeros_like(f), torch.ones_like(f)
        p_inv = torch.stack([
            torch.stack([self.aspect / f, zero, zero, zero]),
            torch.stack([zero, 1.0 / f, zero, zero]),
            torch.stack([zero, zero, zero, -one]),
            torch.stack([zero, zero, one / b, a / b * one])])
        t4 = torch.cat([self.transform, torch.tensor(
            [[0.0, 0.0, 0.0, 1.0]], device=self.transform.device)])
        return t4 @ p_inv

    def generate_rays(self, pixel_ids: torch.Tensor, seed,
                      config: RenderConfig):
        """Primary rays for flat row-major pixel indices. Returns
        (Ray, new_seed)."""
        px = (pixel_ids % self.width).to(torch.float32)
        py = torch.div(pixel_ids, self.width,
                       rounding_mode="floor").to(torch.float32)

        (r1, r2), seed = rng.pcg2d(seed)
        if config.jitter == Jitter.NONE:
            jx = jy = torch.zeros_like(px)
        elif config.jitter == Jitter.UNIFORM:
            jx, jy = r1 - 0.5, r2 - 0.5
        elif config.jitter == Jitter.GAUSS:
            radius = torch.sqrt(
                -2.0 * torch.log(torch.clamp(r1, min=1e-10))) * 0.375
            theta = _TWO_PI * r2
            jx, jy = radius * torch.cos(theta), radius * torch.sin(theta)
        else:  # CIRCLE
            theta = _TWO_PI * r2
            jx, jy = torch.cos(theta), torch.sin(theta)

        # Divide by device tensors: CUDA torch turns division by a Python
        # scalar into a multiply by its reciprocal, which rounds differently
        # from the reference's division.
        wh = torch.tensor([float(self.width), float(self.height)],
                          device=px.device)
        sx = (px + 0.5 + jx) / wh[0] * 2.0 - 1.0
        sy = (py + 0.5 + jy) / wh[1] * 2.0 - 1.0
        half_tan = self.half_tan()
        cx = sx * (half_tan * self.aspect)
        cy = -sy * half_tan
        cz = -torch.ones_like(sx)
        m = self.transform
        d = Vec3(m[0, 0] * cx + m[0, 1] * cy + m[0, 2] * cz,
                 m[1, 0] * cx + m[1, 1] * cy + m[1, 2] * cz,
                 m[2, 0] * cx + m[2, 1] * cy + m[2, 2] * cz).normalize()
        pos = self.position
        o = Vec3(pos.x + d.x * 0.0, pos.y + d.y * 0.0, pos.z + d.z * 0.0)
        return Ray(o=o, d=d), seed
