"""The benchmark's ``grid.inverse`` cell on the CPU at the mid grid (4 x 4
spheres of detail 12, an albedo row each, at 16 x 12): the configuration's own path through
``benchmark.harness`` (``system()``, then the ``inverse`` loop's set-up,
which renders the target and takes the three checked steps) finds every
hit with kernel 3's plain version and recomputes each one in
``_diff_epilogue``; the cell's check against the plain reference holds
with the program unchanged and fails with a fault planted in the step;
and the program's albedo table lists the reference's rows in its order."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gdpathtracing_torch.diff.inverse as inverse
import gdpathtracing_torch.ops.intersect as ti
from gdpathtracing_torch.utils.telemetry import SPANS

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from benchmark import check, harness  # noqa: E402
from benchmark.traffic import LOOPS  # noqa: E402

N, DETAIL = 4, 12  # the cell itself runs the 10 x 10 grid of detail 16
CPU = torch.device("cpu")
SEED = 2**31 + 23


def _mid_cell(monkeypatch):
    """The cell with the program's grid and the reference's at the mid
    size."""
    cell = harness.load_cell("grid.inverse")
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


def _one_pixel(monkeypatch):
    real = inverse.render_radiance

    def altered(*a, **k):
        aovs = real(*a, **k)
        x = aovs.radiance.clone()
        x[x.shape[0] // 2, x.shape[1] // 2] += 1.0
        return aovs._replace(radiance=x)
    monkeypatch.setattr(inverse, "render_radiance", altered)


def _gradient_scaled(monkeypatch):
    """The loss as it is, its gradient half as large again."""
    real = inverse.render_loss

    def scaled(*a, **k):
        loss = real(*a, **k)
        return loss + 0.5 * (loss - loss.detach())
    monkeypatch.setattr(inverse, "render_loss", scaled)


FAULTS = {"unchanged": None, "one_pixel_altered": _one_pixel,
          "gradient_scaled": _gradient_scaled}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_grid_inverse_cell_against_the_reference(monkeypatch, fault):
    cell = _mid_cell(monkeypatch)
    sut = harness.system(cell, CPU, 16, 12)
    prep = ti.prepare_trace_inputs(sut.scene)
    assert prep.superchunks and ti._sc_lite_fits(prep)
    calls = []
    plain = ti.closest_hit_sc_lite_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)
    monkeypatch.setattr(ti, "closest_hit_sc_lite_plain", counted)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    desc, prepare_ref = harness.reference_scene(cell, CPU, 16, 12)
    loop = LOOPS[cell.traffic["loop"]](sut, cell.traffic, SEED,
                                      {"albedo": desc.albedo()})
    recomputes = SPANS.trace_recompute.count
    loop.setup()
    # Every hit of the target render and of the checked steps was found by
    # kernel 3 and recomputed once from the live table.
    assert calls and len(calls) == SPANS.trace_recompute.count - recomputes
    numbers, _ = loop.numbers(prepare_ref())
    ok, checks = check.judge(numbers, check.limits(cell.dir, cell.name))
    if fault == "unchanged":
        assert ok, checks
    else:
        assert not ok
        assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("size", [(N, DETAIL), (10, 16)], ids=["mid", "cell"])
def test_grid_albedo_rows_are_the_references(monkeypatch, size):
    """The inverse loop hands the reference's ``Description.albedo()`` to
    the program as its table: both deduplicate materials by value in the
    order they are added, so each row is the same material's, one a
    sphere besides the default, the floor and the light."""
    n, detail = size
    cell = harness.load_cell("grid.inverse")
    mod = harness.load_module(cell.dir / "configs" / cell.config["reference"])
    monkeypatch.setattr(mod, "N", n)
    monkeypatch.setattr(mod, "DETAIL", detail)
    rows = mod.description().albedo()
    spec = cell.config["scene"]
    scene = harness._call(dict(spec, args=dict(spec["args"], n=n,
                                                sphere_detail=detail)),
                          device="cpu")
    assert rows.shape == (n * n + 3, 3)
    np.testing.assert_array_equal(scene.mat_albedo.numpy(), rows)
