"""Regen's per-segment shading in one kernel launch (``csrc/regen_shade.cu``).

One regen iteration shades the segment each lane just traced, adds its
emission (or the sky's), records the first-hit AOVs and samples the next
direction. In PyTorch that is ~620 elementwise launches an iteration
(render/regen.py ``_shade_torch``); the kernel does it in one, reading the
winner rows and the lane stacks once and writing the new stacks, the
``alive`` / ``dead_now`` masks and their counts.

The wrapper :func:`regen_shade`

- on a CUDA tensor launches the kernel (built by nvcc at first use,
  ops/build.py) and counts the launch in ``regen_shade.launches``;
- on a CPU tensor runs :func:`regen_shade_plain`, regen's torch body on
  the same inputs.

Scope (:func:`shade_kernel_supported`): a scene on the card without
transmission, textures or an environment map, no NEE, no march and no
Russian roulette; regen also needs the traversal's winner rows (kernels 1
and 6; the superchunk lite kernel, BRUTE and UNIT return none).
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.ops.intersect import OUT_R, _hit_from_rows, _launch
from gdpathtracing_torch.ops.megakernel import sky_constants
from gdpathtracing_torch.scene.scene import Scene

_NF, _NI = 17, 6  # render/regen.py's float and int64 lane rows (no march)


def _kernel_takes(scene: Scene, config: RenderConfig) -> bool:
    """No transmission, textures, environment map or Russian roulette."""
    return (not (scene.has_transmission or scene.has_textures
                 or scene.has_mr_textures or scene.has_env)
            and config.rr_start == 0)


def shade_kernel_supported(scene: Scene, config: RenderConfig, march: bool,
                           use_nee: bool) -> bool:
    """Whether regen shades with :func:`regen_shade`: a scene on the card
    that needs none of what the kernel leaves out."""
    return (scene.device.type == "cuda" and not march and not use_nee
            and _kernel_takes(scene, config))


def regen_shade_plain(scene: Scene, rows, fs, ints, active,
                      config: RenderConfig):
    """:func:`regen_shade` in PyTorch: regen's torch body on the hit that
    the winner ``rows`` give."""
    from gdpathtracing_torch.render.regen import _shade_torch

    return _shade_torch(scene, config, _hit_from_rows(rows, active), fs,
                        ints, active)


def regen_shade(scene: Scene, rows: torch.Tensor, fs: torch.Tensor,
                ints: torch.Tensor, active: torch.Tensor,
                config: RenderConfig):
    """Shade one regen iteration of ``n`` lanes: the (48, n) winner
    ``rows`` of their segments (ops/intersect.py layout), the lane stacks
    ``fs`` (17, n) f32 and ``ints`` (6, n) int64 (render/regen.py layout;
    each may be the first n columns of a wider stack) and the (n,) bool
    ``active``. Returns (fs, ints, alive, dead_now, counts): the new
    stacks, (n,) bool masks of the lanes that go on and of those that
    ended now, and their two counts.

    CUDA tensors launch the kernel (counted in ``regen_shade.launches``);
    CPU tensors run :func:`regen_shade_plain`. Raises on a scene or config
    the kernel does not take, and on anything else it cannot read."""
    n = active.shape[0]
    if not _kernel_takes(scene, config) or config.bounces < 1:
        raise ValueError("regen_shade takes no transmission, textures, "
                         "environment map or Russian roulette, and at "
                         "least one bounce")
    for name, x, r, dtype in (("rows", rows, OUT_R, torch.float32),
                              ("fs", fs, _NF, torch.float32),
                              ("ints", ints, _NI, torch.int64)):
        if x.dim() != 2 or x.shape != (r, n) or x.dtype != dtype \
                or x.stride(1) != 1 or x.device != active.device:
            raise ValueError(f"{name} must be ({r}, {n}) {dtype} with "
                             f"unit column stride on {active.device}, got "
                             f"{tuple(x.shape)} {x.dtype} strides "
                             f"{x.stride()} on {x.device}")
    if active.dtype != torch.bool or not active.is_contiguous() or n == 0:
        raise ValueError("active must be a contiguous non-empty bool vector")
    dev = active.device
    if dev.type == "cpu":
        return regen_shade_plain(scene, rows, fs, ints, active, config)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    fs_out = torch.empty((_NF, n), dtype=torch.float32, device=dev)
    ints_out = torch.empty((_NI, n), dtype=torch.int64, device=dev)
    alive = torch.empty(n, dtype=torch.bool, device=dev)
    dead_now = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    _launch("regen_shade", (rows, fs, ints, active, fs_out, ints_out, alive,
                            dead_now, counts),
            n, rows.stride(0), fs.stride(0), ints.stride(0),
            int(config.bounces),
            floats=(config.ray_eps, *sky_constants(config)))
    regen_shade.launches += 1
    return fs_out, ints_out, alive, dead_now, counts


regen_shade.launches = 0
