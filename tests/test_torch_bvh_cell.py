"""The benchmark's ``demo.bvh`` cell on the CPU at 32 x 18: the
configuration's own path through ``benchmark.harness`` (``system()``, then
``Engine.step``) renders with ``RenderConfig()`` itself, traces every
bounce through ``trace_bvh``'s plain version and no PALLAS kernel's,
hands the traversal every lane of every bounce, and the cell's check
against the plain reference holds with the program unchanged (it reads 0:
the port's object-space walk and the reference's world-space BVH pick
the same triangle for every pixel here) and fails with one pixel
altered."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

import gdpathtracing_torch.ops.fused as fused
import gdpathtracing_torch.ops.intersect as ti
import gdpathtracing_torch.ops.megakernel as mega
import gdpathtracing_torch.render.renderer as renderer
import gdpathtracing_torch.render.traverse as traverse
from gdpathtracing_torch import RenderConfig

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from benchmark import harness  # noqa: E402

W, H = 32, 18  # the cell itself runs 1920 x 1080
CPU = torch.device("cpu")
# The PALLAS traversals' plain kernels: none of them runs on this cell.
PALLAS_PLAIN = [(ti, n) for n in dir(ti) if n.endswith("_plain")] + [
    (mega, "mega_step_plain"), (fused, "fused_paths_plain")]


def _one_pixel(aovs):
    x = aovs.radiance.clone()
    x[x.shape[0] // 2, x.shape[1] // 2] += 1.0
    return aovs._replace(radiance=x)


def _counted(monkeypatch, mod, name, calls):
    real = getattr(mod, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)
    monkeypatch.setattr(mod, name, counted)


@pytest.mark.parametrize("answer", ["unchanged", "altered"])
def test_bvh_cell_against_the_reference(monkeypatch, answer):
    cell = harness.load_cell("demo.bvh")
    suts = []
    system = harness.system
    monkeypatch.setattr(harness, "system",
                        lambda *a, **k: suts.append(system(*a, **k))
                        or suts[-1])
    bvh, pallas = [], []
    _counted(monkeypatch, traverse, "trace_bvh_plain", bvh)
    for mod, name in PALLAS_PLAIN:
        _counted(monkeypatch, mod, name, pallas)
    if answer == "altered":
        real = renderer.render_radiance
        monkeypatch.setattr(renderer, "render_radiance",
                            lambda *a, **k: _one_pixel(real(*a, **k)))
    lanes = traverse.trace_bvh.lanes
    out = harness.run_cell(cell, 2**31 + 13, 0.3, False, CPU,
                           time.perf_counter(), width=W, height=H)
    (sut,) = suts
    assert sut.config == RenderConfig()
    assert bvh and not pallas
    # The warm step of set-up, then the window's: every lane each bounce.
    frames = 1 + out["attempted"]
    assert traverse.trace_bvh.lanes - lanes == \
        frames * sut.config.bounces * W * H
    px = out["checks"]["px_mismatch"]
    if answer == "unchanged":
        assert out["correct"] is True and px["value"] == 0.0
    else:
        assert out["correct"] is False and px["value"] > px["limit"]
