"""Top-level render functions — port of ``render_radiance``, ``render``,
``init_post_state`` and ``render_frame`` of
gdpathtracing_tpu/render/renderer.py.

``render_radiance`` traces one frame on the scene's device and returns the
same AOVs as the JAX version: through the path-regeneration loop
(render/regen.py) when ``config.regen`` asks for it (PALLAS, BRUTE, UNIT)
or, as ``None``, by the reference's auto policy (every primal PALLAS
render); otherwise through the standard loop (``trace_pixels``) in tiles
of ``config.tile_rays`` rays, where each tile's ``path_trace`` runs the
bounce loop of its traversal
(PALLAS, BVH, the default ``RenderConfig()``'s, or the plain oracles BRUTE
and UNIT) or, for ``Traversal.MEGA`` and ``Traversal.FUSED``, the path
kernels (one launch a bounce, or one a tile). A differentiable render
always takes the standard loop; its radiance carries the autograd graph
back to the scene and camera tensors. ``render`` adds the ACES tonemap;
``render_frame`` adds the post passes (progressive or temporal
accumulation, the à-trous denoiser, the display transform) over a post
state that ``init_post_state`` makes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdpathtracing_torch.config import DenoisingMode, RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.post.denoise import atrous_denoise
from gdpathtracing_torch.post.display import display_transform
from gdpathtracing_torch.post.progressive import (ProgressiveState,
                                                  progressive_init,
                                                  progressive_update)
from gdpathtracing_torch.post.temporal import (TemporalState, nonlinear_depth,
                                               temporal_init, temporal_update)
from gdpathtracing_torch.post.tonemap import aces_film
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.ops.intersect import prepare_trace_inputs
from gdpathtracing_torch.render.integrator import check_supported, path_trace
from gdpathtracing_torch.render.regen import (regen_auto, regen_supported,
                                              render_radiance_regen)
from gdpathtracing_torch.scene.scene import Scene
from gdpathtracing_torch.utils.telemetry import SPANS


class FrameAOVs(NamedTuple):
    radiance: torch.Tensor  # (H, W, 3) f32 linear
    depth: torch.Tensor     # (H, W) f32 first-hit distance
    steps: torch.Tensor     # (H, W) i32 triangle tests
    segments: torch.Tensor  # (H, W) i32 traced ray segments
    normal: torch.Tensor    # (H, W, 3) f32 first-hit normal (0 on a miss)


def render_radiance(scene: Scene, camera: Camera, config: RenderConfig,
                    frame_index: int = 0) -> FrameAOVs:
    """Trace the full frame on ``scene.device``. MEGA or FUSED outside
    their gates, a differentiable BVH render and ``regen=True`` outside
    PALLAS, BRUTE and UNIT (or with a differentiable or soft render) raise
    ValueError."""
    with SPANS.render_radiance:
        if config.regen is not False:
            if config.regen and not regen_supported(scene, config):
                raise ValueError("config.regen requires a primal "
                                 "BRUTE/UNIT/PALLAS render (no soft "
                                 "shadows/soft primary)")
            if config.regen or regen_auto(scene, config):
                return render_radiance_regen(scene, camera, config,
                                             frame_index)
        w, h = camera.width, camera.height
        n_pix = w * h
        if config.differentiable and config.bwd_checkpoint is None:
            # The auto checkpoint rule at frame scope: without checkpoints
            # the residuals of every tile and sample stay alive until the
            # backward pass, so the estimate counts them all, not one
            # call's wavefront.
            tile = min(config.tile_rays, n_pix)
            padded = -(-n_pix // tile) * tile
            resid = (padded * config.spp * config.bounces
                     * config.bwd_resid_bytes_per_seg)
            config = config.replace(
                bwd_checkpoint=resid > config.bwd_resid_budget)
        rgb, depth, steps, segments, normal = trace_pixels(
            scene, camera, torch.arange(n_pix, device=scene.device),
            frame_index, config)
        return FrameAOVs(radiance=rgb.reshape(h, w, 3),
                         depth=depth.reshape(h, w),
                         steps=steps.reshape(h, w),
                         segments=segments.reshape(h, w),
                         normal=normal.reshape(h, w, 3))


def trace_pixels(scene: Scene, camera: Camera, pids: torch.Tensor,
                 frame_index, config: RenderConfig):
    """The standard loop over a flat batch of pixel ids, on
    ``scene.device``: ``path_trace`` in tiles of ``config.tile_rays`` rays
    (``lax.map`` over tiles becomes a Python loop) → (rgb (n, 3), depth
    (n,), steps (n,), segments (n,), normal (n, 3)), the samples of a pixel
    averaged, depth their minimum, normal the first sample's. A ray's
    result does not depend on the batch it is traced in, so any batch of
    pixels (a rank's share, a re-rendered tile) gives the full frame's
    pixels bit for bit."""
    check_supported(scene, config)
    dev = scene.device
    with SPANS.render_prepare:
        camera = camera.to(dev)
        pids = pids.to(dev)
        prep = prepare_trace_inputs(scene) if config.traversal in (
            Traversal.PALLAS, Traversal.MEGA, Traversal.FUSED) else None
    frame_index = int(frame_index)
    outs = []
    # The tiles' rays, sample sums and cat; path_trace's own leaf spans
    # pause this one.
    with SPANS.path_lanes:
        for k in range(0, pids.shape[0], config.tile_rays):
            ids = pids[k:k + config.tile_rays]
            px = ids % camera.width
            py = torch.div(ids, camera.width, rounding_mode="floor")
            acc = torch.zeros((ids.shape[0], 3), dtype=torch.float32,
                              device=dev)
            depth = normal = None
            steps = segments = 0
            for s in range(config.spp):
                seed = rng.prng_seed(px, py, frame_index * config.spp + s)
                ray, seed = camera.generate_rays(ids, seed, config)
                res = path_trace(scene, ray, seed, config, prep,
                                 far=camera.far)
                acc = acc + res.radiance.to_array()
                depth = res.depth if depth is None \
                    else torch.minimum(depth, res.depth)
                steps = steps + res.steps
                segments = segments + res.segments
                if normal is None:
                    normal = res.normal.to_array()
            outs.append((acc * (1.0 / config.spp), depth, steps, segments,
                         normal))
        return tuple(torch.cat(x) for x in zip(*outs))


def render(scene: Scene, camera: Camera, config: RenderConfig | None = None,
           frame_index: int = 0) -> torch.Tensor:
    """One-shot convenience: trace + ACES tonemap → (H, W, 3) in [0, 1].
    The default config is the JAX default (``Traversal.BVH``, through the
    standard loop)."""
    config = config or RenderConfig()
    aovs = render_radiance(scene, camera, config, frame_index)
    return aces_film(aovs.radiance)


def init_post_state(camera: Camera, config: RenderConfig, device="cuda"):
    """The post state ``config.denoising`` accumulates in, at the camera's
    resolution on ``device`` (the card unless the caller asks for
    another): a ProgressiveState, a TemporalState, or None."""
    if config.denoising == DenoisingMode.PROGRESSIVE:
        return progressive_init(camera.width, camera.height, device)
    if config.denoising == DenoisingMode.TEMPORAL:
        return temporal_init(camera.width, camera.height, device)
    return None


def render_frame(scene: Scene, camera: Camera, config: RenderConfig,
                 state, frame_index: int = 0):
    """One step of the frame loop: trace, accumulate (progressive or
    temporal, by ``config.denoising``), denoise (``spatial_denoise``) and
    the display transform. Returns (image in [0, 1] (H, W, 3), new
    state)."""
    aovs = render_radiance(scene, camera, config, frame_index)
    with SPANS.post_passes:
        camera = camera.to(scene.device)
        if config.denoising == DenoisingMode.PROGRESSIVE:
            if not isinstance(state, ProgressiveState):
                raise TypeError("PROGRESSIVE denoising needs a "
                                "ProgressiveState")
            linear, state = progressive_update(state, aovs.radiance,
                                               camera.transform)
        elif config.denoising == DenoisingMode.TEMPORAL:
            if not isinstance(state, TemporalState):
                raise TypeError("TEMPORAL denoising needs a TemporalState")
            depth_nl = nonlinear_depth(aovs.depth, camera.near, camera.far)
            linear, state = temporal_update(
                state, aovs.radiance, depth_nl, camera.vp(),
                blend=config.temporal_blend,
                depth_eps=config.temporal_depth_eps)
        else:
            linear = aovs.radiance
        if config.spatial_denoise:
            linear = atrous_denoise(linear, aovs.normal, aovs.depth,
                                    iterations=config.denoise_iterations)
        return display_transform(linear, config), state
