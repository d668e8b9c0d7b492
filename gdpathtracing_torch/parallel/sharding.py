"""Multi-device rendering: the rays of a frame strided over the ranks of a
``torch.distributed`` process group — port of
gdpathtracing_tpu/parallel/sharding.py.

The process group takes the place of the reference's device mesh
(``make_mesh``): one rank a device, started by ``torchrun --nproc-per-node
N`` (or by hand, each process calling ``torch.distributed.
init_process_group`` with its rank, the world size and a ``tcp://`` address)
with the ``nccl`` backend on the card and ``gloo`` on the CPU. The caller
makes the group; :func:`render_radiance_sharded` renders on the group it is
given (the default group without one) and raises where none is initialised.

- **Scene replicated, rays sharded**: every rank holds the whole scene on
  its own device; rank r of N traces pixels r, r+N, r+2N, … (strided, so a
  sky-heavy region does not idle one rank while another traces deep
  paths), the frame padded to a multiple of N.
- **Deterministic under resharding**: the RNG stream is keyed by (pixel,
  frame), never by rank, so an N-rank frame equals the single-device
  standard loop's frame bit for bit wherever a ray's answer does not depend
  on the batch it is traced in. The kernels' winners (PALLAS, BVH) do not.
  The tests hold the equality on the CPU for BRUTE, PALLAS ± NEE and UNIT;
  on the card it is measured for PALLAS ± NEE only, and UNIT's cuBLAS
  product (whose kernel may be chosen by the batch size) is not measured.
- **Gradients**: the per-rank results are gathered into the whole frame on
  every rank (``all_gather_into_tensor``). A loss of that replicated frame
  is the same on every rank, so the gather's backward hands each rank the
  cotangent of its own pixels, and each replicated scene or camera tensor
  that requires a gradient sums its gradient over the ranks in the backward
  pass: the transpose of the reference's ``shard_map`` (its ``psum`` over a
  replicated input). Every rank then holds the single-device gradient.
  ``torch.distributed.nn.functional.all_gather`` is not used for this: its
  backward sums every rank's cotangent of a piece, which with the loss
  replicated on N ranks counts each pixel N times.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.render.camera import Camera
# The per-pixel program: the standard loop over a batch of pixel ids.
from gdpathtracing_torch.render.renderer import FrameAOVs
from gdpathtracing_torch.render.renderer import trace_pixels as _trace_pixels
from gdpathtracing_torch.scene.scene import Scene


class _Gather(torch.autograd.Function):
    """All-gather of each rank's (m, c) rows into (N·m, c), rank-major; the
    backward gives each rank its own rows' cotangent (the loss of the
    gathered frame is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        ctx.rows = slice(r * x.shape[0], (r + 1) * x.shape[0])
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None


class _SumGrad(torch.autograd.Function):
    """The identity on a replicated tensor whose gradient is summed over
    the ranks in the backward pass."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _replicated(obj, group):
    """``obj`` (a Scene or Camera) with each tensor field that requires a
    gradient passed through :class:`_SumGrad`."""
    changes = {f.name: _SumGrad.apply(v, group)
               for f in dataclasses.fields(obj)
               if isinstance(v := getattr(obj, f.name), torch.Tensor)
               and v.requires_grad}
    return dataclasses.replace(obj, **changes) if changes else obj


def render_radiance_sharded(scene: Scene, camera: Camera,
                            config: RenderConfig, frame_index,
                            group=None) -> FrameAOVs:
    """The full frame with its pixels strided over the ranks of ``group``
    (the default process group without one): each rank traces its share on
    ``scene.device`` through the standard loop and every rank returns the
    whole frame. Collective: every rank of the group calls it with the same
    arguments (and, for gradients, runs the backward pass). Raises
    RuntimeError where no process group is initialised."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "render_radiance_sharded needs an initialised torch.distributed "
            "process group (torchrun, or init_process_group with nccl on "
            "the card, gloo on the CPU)")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    w, h = camera.width, camera.height
    n_pix = w * h
    per_rank = -(-n_pix // n)
    dev = scene.device
    # Position k of rank r holds pixel k·N + r (the padding wraps around).
    pids = (torch.arange(per_rank, device=dev) * n + r) % n_pix
    rgb, depth, steps, segments, normal = _trace_pixels(
        _replicated(scene, group), _replicated(camera, group), pids,
        frame_index, config)
    f = _Gather.apply(torch.cat([rgb, depth[:, None], normal], dim=1), group)
    i = _Gather.apply(torch.stack([steps, segments], dim=1), group)

    def deinterleave(x):
        """Rank-major (N·per_rank, c) rows → pixel order, unpadded."""
        return x.view(n, per_rank, -1).transpose(0, 1).reshape(
            n * per_rank, -1)[:n_pix]

    f, i = deinterleave(f), deinterleave(i)
    return FrameAOVs(radiance=f[:, 0:3].reshape(h, w, 3),
                     depth=f[:, 3].reshape(h, w),
                     steps=i[:, 0].reshape(h, w),
                     segments=i[:, 1].reshape(h, w),
                     normal=f[:, 4:7].reshape(h, w, 3))
