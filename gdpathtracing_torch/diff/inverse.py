"""Differentiable and inverse rendering — port of
gdpathtracing_tpu/diff/inverse.py.

A differentiable render (``RenderConfig(traversal=Traversal.PALLAS,
differentiable=True)``) returns radiance that carries the autograd graph
back to the scene and camera tensors it read: sampling decisions and pdfs
are detached (render/integrator.py), so the gradient of a pixel functional
is the interior-derivative estimator; silhouettes are differentiated only
through the soft relaxations (``soft_shadows``, ``soft_primary``).

A parameterisation is a pure function ``(base scene or camera, params) ->
scene or camera`` that says what is optimised; this module has the common
ones. Parameters are a tensor or a tuple of tensors; gradients come back in
the same structure.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.scene.dynamic import (update_instance_transforms,
                                              update_vertices)
from gdpathtracing_torch.scene.scene import Scene


# ---- parameterisations ----

def replace_albedo(scene: Scene, albedo: torch.Tensor) -> Scene:
    return dataclasses.replace(scene, mat_albedo=albedo)


def replace_emission(scene: Scene, emission: torch.Tensor) -> Scene:
    return dataclasses.replace(scene, mat_emission=emission)


def replace_vertices(scene: Scene, tri_pos: torch.Tensor) -> Scene:
    """Deform vertices and rebuild the derived tables in the graph
    (scene/dynamic.py ``update_vertices``), so the differentiable
    traversal's recompute from ``isect_cols`` carries vertex gradients."""
    return update_vertices(scene, tri_pos)


def replace_instance_transforms(scene: Scene,
                                transforms: torch.Tensor) -> Scene:
    """Re-pose instances ((I, 3, 4) affines) with the same in-graph table
    rebuild (scene/dynamic.py ``update_instance_transforms``)."""
    return update_instance_transforms(scene, transforms)


def replace_textures(scene: Scene, textures: torch.Tensor) -> Scene:
    return dataclasses.replace(scene, textures=textures)


def replace_camera_transform(camera: Camera,
                             transform: torch.Tensor) -> Camera:
    return dataclasses.replace(camera, transform=transform)


# ---- losses ----

def image_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def render_loss(params, apply_scene: Callable[[Scene, object], Scene],
                base_scene: Scene, camera: Camera, config: RenderConfig,
                target: torch.Tensor, frame_index: int = 0,
                apply_camera: Callable[[Camera, object], Camera] | None = None
                ) -> torch.Tensor:
    """MSE between a render under ``params`` and ``target``. ``params`` may
    feed the scene, the camera, or both (a (scene_p, cam_p) tuple and both
    apply functions)."""
    if apply_camera is not None:
        scene_p, cam_p = params
        scene = apply_scene(base_scene, scene_p)
        camera = apply_camera(camera, cam_p)
    else:
        scene = apply_scene(base_scene, params)
    aovs = render_radiance(scene, camera, config, frame_index)
    return image_mse(aovs.radiance, target)


def _leaves(params):
    """(``params`` as fresh leaves that require grad, in their structure,
    and the flat list of them). ``params``: a tensor or a tuple/list of
    tensors."""
    if isinstance(params, torch.Tensor):
        p = params.detach().requires_grad_(True)
        return p, [p]
    ps = type(params)(x.detach().requires_grad_(True) for x in params)
    return ps, list(ps)


def _grads(params, flat, grads):
    """The gradients in the structure of ``params`` (zeros for a parameter
    the output does not depend on)."""
    g = [torch.zeros_like(p) if x is None else x for p, x in zip(flat, grads)]
    return g[0] if isinstance(params, torch.Tensor) else type(params)(g)


def unbiased_mse_value_and_grad(params, apply_scene, base_scene: Scene,
                                camera: Camera, config: RenderConfig,
                                target: torch.Tensor, frame_a: int,
                                frame_b: int):
    """Decorrelated MSE gradient, the unbiased estimator for Monte-Carlo
    inverse rendering: the residual comes from one render (``frame_a``),
    the derivative from an independent one (``frame_b``), so
    grad = (2/N)·<X_a − T, dX_b/dp> and E[grad] = d‖E[X] − T‖²/dp. With one
    sample set the gradient would also pull towards low-variance
    configurations. Returns (loss of X_a, grad)."""
    def render_fn(p, frame):
        return render_radiance(apply_scene(base_scene, p), camera, config,
                               frame).radiance

    with torch.no_grad():
        x_a = render_fn(params, frame_a)
    residual = 2.0 * (x_a - target) / x_a.numel()
    p, flat = _leaves(params)
    x_b = render_fn(p, frame_b)
    grads = torch.autograd.grad(x_b, flat, grad_outputs=residual,
                                allow_unused=True)
    return torch.mean((x_a - target) ** 2), _grads(params, flat, grads)


def value_and_grad_step(apply_scene, config: RenderConfig,
                        apply_camera=None):
    """A function ``(params, base_scene, camera, target, frame_index=0) ->
    (loss, grads)`` of :func:`render_loss`."""

    def fn(params, base_scene, camera, target, frame_index=0):
        p, flat = _leaves(params)
        loss = render_loss(p, apply_scene, base_scene, camera, config, target,
                           frame_index, apply_camera)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), _grads(params, flat, grads)

    return fn
