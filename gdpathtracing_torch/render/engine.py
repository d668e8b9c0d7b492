"""Engine: the frame loop with its state — port of
gdpathtracing_tpu/render/engine.py.

Holds the scene, the config, the frame index and the post state between
frames; each ``step`` renders one frame through ``render_frame``, eagerly
on the scene's device (the reference compiles the step with ``jax.jit``
and donates the state; here each step's kernels launch as it runs and the
new state replaces the old). A new camera each step is a moving camera.
"""

from __future__ import annotations

import numpy as np
import torch

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.renderer import init_post_state, render_frame
from gdpathtracing_torch.scene.scene import Scene
from gdpathtracing_torch.utils.telemetry import SPANS, Profile


class Engine:
    """The frame loop with its state: ``reset(camera)`` starts the
    accumulation afresh, ``step(camera)`` renders the next frame."""

    def __init__(self, scene: Scene, config: RenderConfig | None = None):
        self.config = config or RenderConfig()
        self.scene = scene
        self.frame_index = 0
        self._state = None

    def reset(self, camera: Camera) -> None:
        self._state = init_post_state(camera, self.config,
                                      self.scene.device)
        self.frame_index = 0

    def step(self, camera: Camera) -> torch.Tensor:
        """Render one frame; returns the display image, (H, W, 3) float32
        in [0, 1] on the scene's device."""
        with SPANS.engine_step:
            if self._state is None:
                self.reset(camera)
            image, self._state = render_frame(self.scene, camera,
                                              self.config, self._state,
                                              self.frame_index)
            self.frame_index += 1
        return image

    def to_uint8(self, image: torch.Tensor) -> np.ndarray:
        """The image as (H, W, 3) uint8 on the host."""
        return np.clip(image.detach().cpu().numpy() * 255.0 + 0.5, 0,
                       255).astype(np.uint8)

    def profile(self, logdir: str) -> Profile:
        """A torch.profiler context for the frame loop (device activity on
        the card, host activity on the CPU) that the spans' timeline joins
        as it starts (utils/telemetry.py ``Profile``) and, when it ends,
        writes one trace to ``logdir`` holding the device operations and
        the program's spans (category ``program_span``) on one clock, and
        sets its ``summary``: each span's host seconds and the device's
        idle seconds inside it (``ProfileSummary``)::

            with engine.profile("trace/") as prof:
                engine.step(camera)
            prof.summary.spans["path_lanes"].idle_s
        """
        return Profile(self.scene.device, logdir)
