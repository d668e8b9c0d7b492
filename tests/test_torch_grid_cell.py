"""The benchmark's ``grid.interactive`` cell on the CPU at the mid grid
(4 x 4 spheres of detail 12 at 16 x 12): the configuration's own path
through ``benchmark.harness`` (``system()``, then ``Engine.step``) takes
the superchunk lite path (kernel 3's plain version), and the cell's check
against the plain reference holds with the program unchanged and fails
with an answer altered where it is produced."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

import gdpathtracing_torch.ops.intersect as ti
import gdpathtracing_torch.render.renderer as renderer

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from benchmark import harness  # noqa: E402

N, DETAIL = 4, 12  # the cell itself runs build_sphere_grid(10, 16)
CPU = torch.device("cpu")


def _mid_cell(monkeypatch):
    """The cell with the program's grid and the reference's at the mid
    size."""
    cell = harness.load_cell("grid.interactive")
    cell.config["scene"]["args"].update(n=N, sphere_detail=DETAIL)
    cell.config["camera"]["args"]["n"] = N
    load = harness.load_module

    def load_mid(path):
        mod = load(path)
        if path.name == cell.config["reference"]:
            mod.N, mod.DETAIL = N, DETAIL
        return mod
    monkeypatch.setattr(harness, "load_module", load_mid)
    return cell


def _one_pixel(aovs):
    x = aovs.radiance.clone()
    x[x.shape[0] // 2, x.shape[1] // 2] += 1.0
    return aovs._replace(radiance=x)


@pytest.mark.parametrize("answer", ["unchanged", "altered"])
def test_grid_cell_against_the_reference(monkeypatch, answer):
    cell = _mid_cell(monkeypatch)
    prep = ti.prepare_trace_inputs(harness.system(cell, CPU, 16, 12).scene)
    assert prep.superchunks and ti._sc_lite_fits(prep)
    calls = []
    plain = ti.closest_hit_sc_lite_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)
    monkeypatch.setattr(ti, "closest_hit_sc_lite_plain", counted)
    if answer == "altered":
        real = renderer.render_radiance
        monkeypatch.setattr(renderer, "render_radiance",
                            lambda *a, **k: _one_pixel(real(*a, **k)))
    out = harness.run_cell(cell, 2**31 + 11, 0.3, False, CPU,
                           time.perf_counter(), width=16, height=12)
    assert calls
    px = out["checks"]["px_mismatch"]
    if answer == "unchanged":
        assert out["correct"] is True and px["value"] == 0.0
    else:
        assert out["correct"] is False and px["value"] > px["limit"]
