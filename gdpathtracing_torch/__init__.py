"""gdpathtracing_torch — the PyTorch / CUDA port of gdpathtracing_tpu.

Same module layout and names as the JAX package, so each counterpart sits at
the same path. This package imports torch and never JAX. It renders every
primal ``RenderConfig`` of the reference: ``Traversal.PALLAS`` over scenes
of any size (more than 16 triangle chunks take the two-level superchunk
traversal), through the path-regeneration loop (the default) or the
standard per-bounce loop (``regen=False``); ``Traversal.BVH``, the default;
the plain oracles ``Traversal.BRUTE`` and ``Traversal.UNIT`` (standard
loop, or regen with ``regen=True``); each with or without next-event
estimation (``nee=True``), Russian roulette (``rr_start > 0``) and
dielectric transmission; and the path kernels' traversals
``Traversal.MEGA`` (one kernel per bounce; flat untextured scenes of at
most 16 chunks) and ``Traversal.FUSED`` (all bounces in one kernel; no
NEE, at most 16384 triangles), which raise ValueError outside the
reference's gates, with ``regen=True`` or with ``differentiable=True``.
The differentiable render (``differentiable=True``, with soft shadows and
soft primary silhouettes; ``diff/`` and ``scene/dynamic.py``) runs on
PALLAS, BRUTE and UNIT. Regen's frontier march (``regen_march=True``)
renders on the superchunk scenes the reference marches on, and the classic
closest hit (``ops.intersect.trace_pallas_classic``) is public as in the
reference. The frame loop — ``render_frame`` with progressive or temporal
accumulation, the à-trous denoiser and the display transform, and the
``Engine`` that drives it — is in ``render/`` and ``post/``. All eleven
kernels of the reference are in CUDA (``ops/intersect.py``,
``ops/megakernel.py``, ``ops/fused.py``, ``csrc/``): flat closest hit,
occlusion, the two fused, the two-level closest hit with and without
winner rows, the soft-shadow top-1 blocker, one round of the march, the
classic (t, idx) closest hit and its block-gated loop form, MEGA's
per-bounce megakernel and FUSED's all-bounces kernel. Scenes are built on
the GPU unless the caller asks for another device. Regen's two options of
ROADMAP queue 1, item 5 raise NotImplementedError naming it.

Entry points: ``render.renderer.render_radiance``, ``render.renderer.render``
(not re-exported here, where its name would shadow the ``render``
subpackage), ``render_frame`` and ``Engine``.
"""

import torch

# The reference computes in full float32; no TF32 anywhere (the port itself
# uses no matmul or convolution, this keeps callers' own products honest).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gdpathtracing_torch.config import (DenoisingMode, Jitter, RenderConfig,
                                        Traversal)
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.engine import Engine
from gdpathtracing_torch.render.renderer import (FrameAOVs, render_frame,
                                                 render_radiance)
from gdpathtracing_torch.scene.materials import Material
from gdpathtracing_torch.scene.scene import (Scene, SceneBuilder,
                                             scene_from_arrays)

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "DenoisingMode", "Jitter", "Traversal", "Scene",
    "SceneBuilder", "scene_from_arrays", "Material", "Camera", "FrameAOVs",
    "render_radiance", "render_frame", "Engine",
]
