"""Render configuration — field-for-field mirror of gdpathtracing_tpu.config.

The port keeps its own copy because importing ``gdpathtracing_tpu`` pulls in
JAX. Every field, type and default equals the JAX ``RenderConfig``
(tests/test_torch_config.py holds the two together). Which fields the torch
port actually renders is decided by ``render.renderer``: anything outside the
ported slice raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import enum


class DenoisingMode(enum.Enum):
    PROGRESSIVE = "progressive"
    TEMPORAL = "temporal"
    NONE = "none"


class Traversal(enum.Enum):
    """Which intersection backend the integrator uses."""

    BRUTE = "brute"    # O(rays x tris) Möller–Trumbore oracle
    BVH = "bvh"        # two-level TLAS/BLAS stack traversal
    UNIT = "unit"      # O(rays x tris) unit-triangle-space formulation
    PALLAS = "pallas"  # chunked closest-hit rows kernel (CUDA in this port)
    FUSED = "fused"    # all bounces in one kernel
    MEGA = "mega"      # one kernel per bounce incl. shading and NEE


class Tonemap(enum.Enum):
    ACES = "aces"
    REINHARD = "reinhard"
    LINEAR = "linear"


class Jitter(enum.Enum):
    NONE = "none"
    UNIFORM = "uniform"   # uniform in [-0.5, 0.5]^2 around the pixel center
    GAUSS = "gauss"       # Gaussian, sigma = 0.375 px (Box–Muller)
    CIRCLE = "circle"     # point on the unit circle


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings. See gdpathtracing_tpu/config.py for the
    meaning of each field; the defaults here are identical."""

    bounces: int = 5
    spp: int = 1
    ray_eps: float = 1e-3
    nee: bool = False
    rr_start: int = 0
    rr_min_p: float = 0.05
    sort_rays: bool | None = None     # None = auto (on for >128-chunk scenes)
    compact_rays: bool | None = None  # None = auto (on for >= 65536 rays)
    regen: bool | None = None         # None = auto (regen for PALLAS primal)
    differentiable: bool = False
    bwd_checkpoint: bool | None = None
    bwd_resid_bytes_per_seg: int = 160
    bwd_resid_budget: int = 4 << 30
    grad_attached: bool = False
    soft_shadows: float = 0.0
    soft_primary: float = 0.0
    traversal: Traversal = Traversal.BVH
    jitter: Jitter = Jitter.UNIFORM
    max_stack: int = 64
    tile_rays: int = 262144
    regen_wavefront: int = 393216
    regen_retire: str = "log"
    regen_sort_key: str = "morton"
    regen_march: bool | None = None
    regen_fuse_nee: bool = False
    regen_drain: bool | None = None
    regen_drain_wavefront: int | None = None
    regen_march_k: int = 6
    regen_march_ql: int = 8
    temporal_blend: float = 0.75
    temporal_depth_eps: float = 0.1
    denoising: DenoisingMode = DenoisingMode.PROGRESSIVE
    spatial_denoise: bool = False
    denoise_iterations: int = 3
    tonemap: Tonemap = Tonemap.ACES
    exposure: float = 1.0
    bloom: bool = False
    bloom_threshold: float = 1.0
    bloom_strength: float = 0.15
    bloom_radius: int = 8
    sky_horizon: tuple[float, float, float] = (0.95, 0.95, 0.95)
    sky_zenith: tuple[float, float, float] = (0.9, 0.94, 1.0)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
