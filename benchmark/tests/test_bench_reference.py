"""The plain reference against the port (the test may import both; the
reference itself imports neither), and its BVH against brute force."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import bvh, render
from benchmark.reference.scene import compile_tables

gpt = pytest.importorskip("gdpathtracing_torch")
from gdpathtracing_torch.diff.inverse import (render_loss,  # noqa: E402
                                              replace_albedo)
from gdpathtracing_torch.scene.demo import (build_demo_scene,  # noqa: E402
                                            demo_camera)


def _demo_ref(w, h):
    cell = harness.load_cell("demo.interactive")
    desc, prepare = harness.reference_scene(cell, torch.device("cpu"), w, h)
    return desc, prepare()


@pytest.mark.parametrize("frame", [0, 3, 4000000000])
def test_reference_equals_the_port_at_16x16(frame):
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6,
                             device="cpu")
    cfg = gpt.RenderConfig(traversal=gpt.Traversal.PALLAS)
    want = gpt.render_radiance(scene, demo_camera(16, 16), cfg,
                               frame).radiance
    _, ref = _demo_ref(16, 16)
    got, counts = render.render(ref, frame)
    assert torch.equal(got, want)
    assert counts.segments >= 256 and counts.boxes > counts.segments
    assert counts.tris > 0


def test_reference_inverse_steps_equal_the_port():
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6,
                             device="cpu")
    cam = demo_camera(16, 16)
    cfg = gpt.RenderConfig(traversal=gpt.Traversal.PALLAS,
                           differentiable=True)
    desc, ref = _demo_ref(16, 16)
    a0 = torch.as_tensor(desc.albedo())
    target = torch.clamp(a0 * 0.9, 0.0, 1.0)
    want_t = gpt.render_radiance(replace_albedo(scene, target), cam, cfg,
                                 9).radiance.detach()
    got_t, _ = render.render(ref, 9, albedo=target)
    assert torch.equal(got_t, want_t)
    p = a0.clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=1e-3)
    losses = []
    for f in (1, 2, 3):
        loss = render_loss(p, replace_albedo, scene, cam, cfg, want_t, f)
        (g,) = torch.autograd.grad(loss, [p])
        if f == 1:
            g1 = g.clone()
        p.grad = g
        opt.step()
        with torch.no_grad():
            p.clamp_(0.0, 1.0)
        losses.append(float(loss.detach()))
    r_losses, r_g1, r_p, _ = render.inverse_steps(ref, a0, got_t, [1, 2, 3],
                                                  1e-3)
    assert r_losses == losses
    assert torch.allclose(r_g1, g1, rtol=1e-5, atol=1e-9)
    assert torch.allclose(r_p, p.detach(), rtol=0, atol=1e-7)


def _brute(tab, o, d):
    m = tab.cols
    ox, oy, oz = (x[:, None] for x in o.unbind(1))
    dx, dy, dz = (x[:, None] for x in d.unbind(1))
    w_d = dx * m[:, 8] + dy * m[:, 9] + dz * m[:, 10] + 0.0 * m[:, 11]
    w_o = ox * m[:, 8] + oy * m[:, 9] + oz * m[:, 10] + 1.0 * m[:, 11]
    ok = torch.abs(w_d) > 1e-12
    t = -w_o / torch.where(ok, w_d, 1.0)
    u = (ox * m[:, 0] + oy * m[:, 1] + oz * m[:, 2] + 1.0 * m[:, 3]) + t * (
        dx * m[:, 0] + dy * m[:, 1] + dz * m[:, 2] + 0.0 * m[:, 3])
    v = (ox * m[:, 4] + oy * m[:, 5] + oz * m[:, 6] + 1.0 * m[:, 7]) + t * (
        dx * m[:, 4] + dy * m[:, 5] + dz * m[:, 6] + 0.0 * m[:, 7])
    t = torch.where(ok & (t > 0) & (u >= 0) & (v >= 0) & (u + v <= 1), t,
                    1e9)
    return t.min(1)


def test_bvh_closest_hit_equals_brute_force():
    desc, _ = _demo_ref(4, 4)
    tab = compile_tables(desc, "cpu")
    tree = bvh.build(tab.lo, tab.hi)
    assert int(tree.count.sum()) == tab.cols.shape[0]
    assert int(tree.count.max()) <= bvh.LEAF
    g = torch.Generator().manual_seed(3)
    o = torch.rand(4096, 3, generator=g) * 6.0 - 3.0
    d = torch.nn.functional.normalize(torch.randn(4096, 3, generator=g),
                                      dim=1)
    hits = bvh.closest_hit(tree, tab.cols, o, d,
                           torch.ones(4096, dtype=torch.bool))
    want_t, want_e = _brute(tab, o, d)
    assert torch.equal(hits.t, want_t)
    hit = want_t < 1e9
    assert torch.equal(hits.e[hit], want_e[hit])
    assert (hits.boxes > 0).all()
    # A BVH visit tests far fewer triangles than every triangle.
    assert hits.tris.float().mean() < 0.1 * tab.cols.shape[0]


def test_tables_of_the_grid_expand_every_instance(grid_root):
    cell = harness.load_cell("grid.interactive", grid_root)
    desc, _ = harness.reference_scene(cell, torch.device("cpu"))
    tab = compile_tables(desc, "cpu")
    assert tab.cols.shape == (96004, 12)
    assert np.isfinite(tab.cols.numpy()).all()
