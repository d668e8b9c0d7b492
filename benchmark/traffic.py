"""The general generator: the loops a traffic file asks for.

A traffic file (``benchmark/traffic/<mix>.json``) names its ``loop`` and
that loop's parameters. Each loop is driven the same way by the harness:
``setup()`` warms every shape the window uses, ``step()`` is one unit of
the window (the harness synchronises after it), ``attempted_failed()``
counts the window's steps, ``release()`` drops the program's state (what
the check compares stays) and ``numbers(ref)`` compares with the plain
reference.

The seed picks the frame indices (and, for ``inverse``, the target); the
program receives only the scene, the camera, the frame indices and the
inputs the benchmark made.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import check
from benchmark.reference import render as ref_render


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class EngineLoop:
    """``"engine"``: a viewer's still camera, one ``Engine.step`` after
    another, each synchronised. Checked: the first step from a reset
    state, and ``sampled_steps`` steps of the window drawn from the seed
    (a reservoir over all of them): the radiance each added to the
    progressive accumulator, and the display image it returned."""

    def __init__(self, sut, params: dict, seed: int, inputs: dict):
        self.sut = sut
        self.slots = int(params.get("sampled_steps", 2))
        self.first_frame = int(np.random.default_rng([seed, 0])
                               .integers(0, 1 << 20))
        self.pick = np.random.default_rng([seed, 1])
        self.kept: list = []
        self.window_steps = 0
        self.count = 0
        self.spans = None

    def _accum(self) -> torch.Tensor:
        # The engine's progressive state, found by its accumulator field.
        return next(v for v in vars(self.engine).values()
                    if hasattr(v, "accum")).accum

    def _step(self, slot: int | None) -> None:
        frame = self.engine.frame_index
        prev = self._accum().clone() if slot is not None and self.count \
            else None
        out = self.engine.step(self.sut.camera)
        self.count += 1
        if slot is None:
            return
        cur = self._accum().clone()
        rec = (torch.zeros_like(cur) if prev is None else prev, cur, out,
               frame, self.count)
        if slot < len(self.kept):
            self.kept[slot] = rec
        else:
            self.kept.append(rec)

    def setup(self) -> None:
        self.engine = self.sut.Engine(self.sut.scene, self.sut.config)
        self.engine.reset(self.sut.camera)
        self.engine.frame_index = self.first_frame
        self._step(0)
        _sync(self.sut.device)

    def step(self) -> None:
        self.window_steps += 1
        i = self.window_steps
        slot = i if i <= self.slots else int(self.pick.integers(0, i)) + 1
        self._step(slot if slot <= self.slots else None)

    def attempted_failed(self) -> tuple[int, int]:
        return self.window_steps, 0

    def release(self) -> None:
        self.engine = self.sut = None

    def numbers(self, ref) -> tuple[dict, list]:
        bad, counts = [], []
        for prev, cur, out, frame, count in self.kept:
            rad, c = ref_render.render(ref, frame)
            bad.append(check.pixel_mismatch(prev, cur, out, rad, count)
                       .flatten())
            counts.append(c)
        return {"px_mismatch": float(torch.cat(bad).float().mean())}, counts


class InverseLoop:
    """``"inverse"``: inverse rendering of the albedo table. Set-up renders
    the target with an albedo table perturbed from the seed (each entry
    times 1 + ``perturb`` · U(-1, 1), clipped to [0, 1]), then drives the
    step through its first ``checked_steps`` steps. A step is the image
    MSE at a new frame index (``diff.inverse.render_loss``), its gradient
    by ``torch.autograd.grad`` and one ``torch.optim.Adam`` step of the
    table, projected onto [0, 1]. Checked: each of those steps' loss, the
    first gradient as Adam holds it after one step, and the table's change
    after them."""

    def __init__(self, sut, params: dict, seed: int, inputs: dict):
        self.sut = sut
        self.lr = float(params["lr"])
        self.n_checked = int(params.get("checked_steps", 3))
        rng = np.random.default_rng([seed, 0])
        self.first_frame = int(rng.integers(0, 1 << 20))
        self.target_frame = int(rng.integers(1 << 21, 1 << 22))
        self.albedo0 = np.asarray(inputs["albedo"], np.float32)
        u = rng.uniform(-1.0, 1.0, self.albedo0.shape).astype(np.float32)
        self.albedo_target = np.clip(
            self.albedo0 * (1.0 + float(params["perturb"]) * u), 0.0,
            1.0).astype(np.float32)
        self.losses: list = []
        self.spans = None

    def _step(self) -> torch.Tensor:
        inv, dev = self.sut.inverse, self.sut.device
        if self.spans is not None:
            _sync(dev)
            t0 = time.perf_counter()
        loss = inv.render_loss(self.p, inv.replace_albedo, self.sut.scene,
                               self.sut.camera, self.sut.config, self.target,
                               self.frame)
        if self.spans is not None:
            _sync(dev)
            t1 = time.perf_counter()
        (grad,) = torch.autograd.grad(loss, [self.p])
        if self.spans is not None:
            _sync(dev)
            self.spans.setdefault("render_loss", []).append(t1 - t0)
            self.spans.setdefault("autograd.grad", []).append(
                time.perf_counter() - t1)
        self.p.grad = grad
        self.opt.step()
        with torch.no_grad():
            self.p.clamp_(0.0, 1.0)
        self.frame += 1
        return loss.detach()

    def setup(self) -> None:
        dev, inv = self.sut.device, self.sut.inverse
        with torch.no_grad():
            target = inv.replace_albedo(
                self.sut.scene, torch.as_tensor(self.albedo_target,
                                                device=dev))
            self.target = self.sut.render_radiance(
                target, self.sut.camera, self.sut.config,
                self.target_frame).radiance
        self.p = torch.as_tensor(self.albedo0, device=dev).clone() \
            .requires_grad_(True)
        self.opt = torch.optim.Adam([self.p], lr=self.lr)
        self.frame = self.first_frame
        beta1 = self.opt.param_groups[0]["betas"][0]
        self.checked_losses = []
        for k in range(self.n_checked):
            self.checked_losses.append(float(self._step()))
            if k == 0:
                self.grad1 = (self.opt.state[self.p]["exp_avg"]
                              / (1.0 - beta1)).clone()
        self.change = (self.p.detach() - torch.as_tensor(
            self.albedo0, device=dev)).clone()
        _sync(dev)

    def step(self) -> None:
        self.losses.append(self._step())

    def attempted_failed(self) -> tuple[int, int]:
        if not self.losses:
            return 0, 0
        bad = int((~torch.isfinite(torch.stack(self.losses))).sum())
        return len(self.losses), bad

    def release(self) -> None:
        self.p = self.opt = self.target = self.sut = None

    def numbers(self, ref) -> tuple[dict, list]:
        dev = ref.camera.transform.device
        a0 = torch.as_tensor(self.albedo0, device=dev)
        target, _ = ref_render.render(
            ref, self.target_frame,
            albedo=torch.as_tensor(self.albedo_target, device=dev))
        frames = [self.first_frame + k for k in range(self.n_checked)]
        losses, g1, p, counts = ref_render.inverse_steps(
            ref, a0, target, frames, self.lr)
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(self.checked_losses, losses))
        return {"loss_gap": loss_gap,
                "grad_gap": check.leaf_gap(self.grad1, g1, g1),
                "update_gap": check.leaf_gap(self.change, p - a0, g1)}, counts


LOOPS = {"engine": EngineLoop, "inverse": InverseLoop}
