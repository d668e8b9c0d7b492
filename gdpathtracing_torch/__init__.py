"""gdpathtracing_torch — the PyTorch / CUDA port of gdpathtracing_tpu.

Same module layout and names as the JAX package, so each counterpart sits at
the same path. This package imports torch and never JAX. Ported so far: a
primal ``Traversal.PALLAS`` render (``RenderConfig(traversal=
Traversal.PALLAS)``) over scenes of any size (more than 16 triangle chunks
take the two-level superchunk traversal), through the path-regeneration
loop (the default) or the standard per-bounce loop (``regen=False``), with
or without next-event estimation (``nee=True``), and the differentiable
render (``differentiable=True``, with soft shadows and soft primary
silhouettes; ``diff/`` and ``scene/dynamic.py``); and the path kernels'
traversals through the standard tile loop: ``Traversal.MEGA`` (one kernel
per bounce, with NEE and Russian roulette; flat untextured scenes of at
most 16 chunks) and ``Traversal.FUSED`` (all bounces in one kernel; no NEE,
at most 16384 triangles), which raise ValueError outside the reference's
gates, with ``regen=True`` or with ``differentiable=True``. Regen's
frontier march (``regen_march=True``) renders on the superchunk scenes the
reference marches on, and the classic closest hit
(``ops.intersect.trace_pallas_classic``) is public as in the reference.
All eleven kernels of the reference are in CUDA (``ops/intersect.py``,
``ops/megakernel.py``, ``ops/fused.py``, ``csrc/``): flat closest hit,
occlusion, the two fused, the two-level closest hit with and without
winner rows, the soft-shadow top-1 blocker, one round of the march, the
classic (t, idx) closest hit and its block-gated loop form, MEGA's
per-bounce megakernel and FUSED's all-bounces kernel. Scenes are built on the GPU unless the caller asks for another
device. Everything else raises NotImplementedError naming its ROADMAP
item.

Entry points: ``render.renderer.render_radiance`` and ``render.renderer.render``
(the latter is not re-exported here, where its name would shadow the
``render`` subpackage).
"""

import torch

# The reference computes in full float32; no TF32 anywhere (the port itself
# uses no matmul or convolution, this keeps callers' own products honest).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gdpathtracing_torch.config import (DenoisingMode, Jitter, RenderConfig,
                                        Traversal)
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.renderer import FrameAOVs, render_radiance
from gdpathtracing_torch.scene.materials import Material
from gdpathtracing_torch.scene.scene import (Scene, SceneBuilder,
                                             scene_from_arrays)

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "DenoisingMode", "Jitter", "Traversal", "Scene",
    "SceneBuilder", "scene_from_arrays", "Material", "Camera", "FrameAOVs",
    "render_radiance",
]
