"""Structure-of-arrays 3-vector math on ``(N,)`` torch tensors.

Port of gdpathtracing_tpu/core/vec.py. A :class:`Vec3` is a NamedTuple of
three equally shaped tensors (or Python scalars); every operation is
elementwise and evaluates its terms in the same order as the JAX version,
so results agree to rounding.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

Scalar = Union[torch.Tensor, float, int]


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # ---- constructors ----
    @classmethod
    def full(cls, v: Scalar, like: "Vec3 | None" = None) -> "Vec3":
        if like is not None:
            v = torch.full_like(like.x, float(v))
        else:
            v = torch.as_tensor(v, dtype=torch.float32)
        return cls(v, v, v)

    @classmethod
    def from_array(cls, a: torch.Tensor, axis: int = -1) -> "Vec3":
        return cls(*(a.select(axis, i) for i in range(3)))

    def to_array(self, axis: int = -1) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=axis)

    # ---- arithmetic ----
    def _coerce(self, o):
        if isinstance(o, Vec3):
            return o
        return Vec3(o, o, o)

    def __add__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __truediv__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __rtruediv__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(o.x / self.x, o.y / self.y, o.z / self.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    # ---- geometry ----
    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.length_sq())

    def normalize(self, eps: float = 0.0) -> "Vec3":
        if eps > 0.0:
            inv = torch.where(self.length_sq() > eps, 1.0 / self.length(),
                              0.0)
        else:
            inv = 1.0 / self.length()
        return self * inv

    def minimum(self, o: "Vec3") -> "Vec3":
        return Vec3(torch.minimum(self.x, o.x), torch.minimum(self.y, o.y),
                    torch.minimum(self.z, o.z))

    def maximum(self, o: "Vec3") -> "Vec3":
        return Vec3(torch.maximum(self.x, o.x), torch.maximum(self.y, o.y),
                    torch.maximum(self.z, o.z))

    def min_component(self) -> torch.Tensor:
        return torch.minimum(self.x, torch.minimum(self.y, self.z))

    def max_component(self) -> torch.Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def sum(self) -> torch.Tensor:
        return self.x + self.y + self.z

    def luminance(self) -> torch.Tensor:
        """Rec.709 luma."""
        return 0.2126 * self.x + 0.7152 * self.y + 0.0722 * self.z

    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.to(dtype), self.y.to(dtype), self.z.to(dtype))

    def detach(self) -> "Vec3":
        return Vec3(self.x.detach(), self.y.detach(), self.z.detach())


def where(mask: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    """Componentwise select; `mask` broadcasts against each component."""
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a + (b - a) * t


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """GLSL reflect(): d - 2*dot(d, n)*n."""
    return d - n * (2.0 * d.dot(n))
