"""Material model — the StandardMaterial3D subset the reference supports.

Host-side, identical to gdpathtracing_tpu/scene/materials.py.

Analog of the reference's GpuMaterial flattening
(src/path_tracing/geometry_group3d.cpp:271-292; struct
render_parameters.h:49-57): albedo color, emission (rgb + energy
multiplier), metallic, roughness, optional albedo texture. The default
material is grey 0.5 albedo / 0.5 roughness / 0 metallic
(geometry_group3d.cpp:239-247).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Material:
    albedo: tuple[float, float, float] = (1.0, 1.0, 1.0)
    emission: tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_energy: float = 0.0
    metallic: float = 0.0
    roughness: float = 1.0
    transmission: float = 0.0  # dielectric transparency (wishlist item)
    ior: float = 1.5
    albedo_texture: "np.ndarray | None" = None  # (H, W, 3) float or uint8
    # glTF-convention metallic-roughness texture: G=roughness, B=metallic
    metallic_roughness_texture: "np.ndarray | None" = None

    def key(self):
        """Dedupe key (texture identity by object id, matching the
        reference's pointer dedupe at geometry_group3d.cpp:137-148)."""
        return (self.albedo, self.emission, self.emission_energy,
                self.metallic, self.roughness, self.transmission, self.ior,
                id(self.albedo_texture),
                id(self.metallic_roughness_texture))


DEFAULT_MATERIAL = Material(albedo=(0.5, 0.5, 0.5), roughness=0.5)


def resize_texture(img: np.ndarray, resolution: int) -> np.ndarray:
    """Decompress-and-resize analog of geometry_group3d.cpp:294-303: every
    albedo texture becomes one square float32 slice of the texture array.
    Bilinear resampling."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    img = img[:, :, :3]
    h, w = img.shape[:2]
    if (h, w) == (resolution, resolution):
        return img
    # Bilinear resize on host.
    ys = (np.arange(resolution, dtype=np.float32) + 0.5) * (h / resolution) - 0.5
    xs = (np.arange(resolution, dtype=np.float32) + 0.5) * (w / resolution) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx)
    b = img[y0][:, x1] * (1 - fy) * fx
    c = img[y1][:, x0] * fy * (1 - fx)
    d = img[y1][:, x1] * fy * fx
    return (a + b + c + d).astype(np.float32)
