"""The control of each cell, at a size a test run holds: the reference
with its path state in bfloat16, put in the program's place, comes out
not correct under the cell's limits (at the cells' own size on the card:
``python3 benchmark/control.py``)."""

import pytest
import torch

from benchmark import check, control, harness


@pytest.mark.parametrize("name", ["demo.interactive", "grid.interactive",
                                  "demo.inverse"])
def test_control_fails(grid_root, name):
    cell = harness.load_cell(name, grid_root)
    desc, prepare = harness.reference_scene(cell, torch.device("cpu"), 16, 12)
    ref = prepare()
    lim = check.limits(cell.dir, name)
    for seed in (1, 2, 3):
        if cell.traffic["loop"] == "engine":
            readings = control.engine_control(ref, seed)
        else:
            readings = control.inverse_control(ref, cell, seed,
                                               desc)["control"]
        ok, _ = check.judge(readings, lim)
        assert not ok, readings
