"""The differentiable standard loop's shading as one autograd node (ops/shade.py
``diff_bounce``: ``path_shade_diff`` forward, ``path_shade_diff_bwd``
backward, csrc/path_shade.cu on the card) on the CPU, where both wrappers run
their plain versions: the entry ``path_trace`` asks (``path_shade_entry``
says ``"diff"``), the wrappers' refusals, the forward bit for bit against
the loop's torch body, the analytic backward against autograd through that
body, whole renders with and without per-bounce checkpoints and under
no_grad, and the albedo gradient against JAX's. The kernels themselves run
only on the card (tests/test_torch_cuda.py ``-k path_shade_diff``).

The torch body is forced by patching ``integrator.path_shade_entry`` to
return None. Gradients are held per albedo row by the relative gap of
norms, ``|‖a‖ − ‖b‖| / ‖b‖`` (benchmark/check.py's measure), and by the
relative norm of the difference.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdpathtracing_tpu.ops.intersect_pallas as jip
from gdpathtracing_tpu.config import (Jitter as JJitter,
                                      RenderConfig as JRenderConfig,
                                      Traversal as JTraversal)
from gdpathtracing_tpu.core import rng as jrng
from gdpathtracing_tpu.render.integrator import path_trace as jax_path_trace
from gdpathtracing_tpu.scene.demo import (build_demo_scene as jax_demo_scene,
                                          demo_camera as jax_demo_camera)

from gdpathtracing_torch.config import Jitter, RenderConfig, Traversal
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.diff.inverse import (replace_albedo,
                                              replace_emission,
                                              replace_instance_transforms,
                                              replace_vertices)
from gdpathtracing_torch.ops import shade
from gdpathtracing_torch.ops.intersect import trace_pallas_diff
from gdpathtracing_torch.render import integrator
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.render.types import Ray
from gdpathtracing_torch.scene import demo as tdemo
from gdpathtracing_torch.scene import primitives as tprim
from gdpathtracing_torch.scene.materials import Material
from gdpathtracing_torch.scene.scene import Scene, SceneBuilder

torch.set_num_threads(1)
DIFF = RenderConfig(traversal=Traversal.PALLAS, differentiable=True)
AOVS = ("radiance", "depth", "steps", "segments", "normal")
# The analytic backward against autograd through the torch body: per
# albedo row (and per throughput component) within 1e-5, both gaps. The
# two multiply the same factors in another order and sum the rows of
# index_add_ in the same order; measured at most 2.4e-7.
GRAD_RTOL = 1e-5


def _glass_room() -> Scene:
    b = SceneBuilder(texture_resolution=4)
    sphere = b.add_mesh(tprim.uv_sphere(radius=1.0, rings=6, segments=12))
    b.add_instance(sphere, np.eye(4, dtype=np.float32)[:3],
                   materials=[Material(albedo=(1, 1, 1), transmission=1.0,
                                       ior=1.5, roughness=0.05)])
    return b.build("cpu")


@pytest.fixture(scope="module")
def scenes():
    return {
        "demo": tdemo.build_demo_scene(texture_resolution=8, sphere_detail=6,
                                       device="cpu"),
        "grid": tdemo.build_sphere_grid(n=4, sphere_detail=12, device="cpu",
                                        instance_albedo=True),
        "glass": _glass_room()}


def _albedo_leaf(scene: Scene) -> Scene:
    return replace_albedo(scene, scene.mat_albedo.clone().requires_grad_())


def _gate_case(scenes, case):
    """(scene, config, ray or None) of a gate case."""
    demo = scenes["demo"]
    alb = _albedo_leaf(demo)
    ray = Ray(Vec3(*torch.zeros(3, 4)), Vec3(*torch.ones(3, 4)))
    grad_ray = Ray(Vec3(*torch.zeros(3, 4).requires_grad_()), ray.d)
    cases = {
        "albedo": (alb, DIFF, ray),
        "albedo_no_ray": (alb, DIFF, None),
        "nothing_wants_grad": (demo, DIFF, ray),
        "grid_sorted": (_albedo_leaf(scenes["grid"]),
                        DIFF.replace(sort_rays=True), ray),
        "bwd_checkpoint": (alb, DIFF.replace(bwd_checkpoint=True), ray),
        "primal": (alb, DIFF.replace(differentiable=False), ray),
        "vertices": (replace_vertices(
            demo, demo.tri_pos.clone().requires_grad_()), DIFF, ray),
        "instance_transforms": (replace_instance_transforms(
            demo, demo.inst_transform.clone().requires_grad_()), DIFF, ray),
        "camera": (alb, DIFF, grad_ray),
        "emission": (replace_emission(
            alb, demo.mat_emission.clone().requires_grad_()), DIFF, ray),
        "nee": (alb, DIFF.replace(nee=True), ray),
        "soft_primary": (alb, DIFF.replace(soft_primary=0.01), ray),
        "grad_attached": (alb, DIFF.replace(grad_attached=True), ray),
        "too_many_materials": (replace_albedo(demo, torch.full(
            (shade.DIFF_MAX_MATS + 1, 3), 0.5).requires_grad_()), DIFF, ray),
        "rr": (alb, DIFF.replace(rr_start=2), ray),
        "no_bounces": (alb, DIFF.replace(bounces=0), ray),
        "glass": (_albedo_leaf(scenes["glass"]), DIFF, ray),
        "brute": (alb, DIFF.replace(traversal=Traversal.BRUTE), ray),
        "unit": (alb, DIFF.replace(traversal=Traversal.UNIT), ray),
    }
    return cases[case]


# the gate's answer for each case of _gate_case
GATE = {"albedo": "diff", "albedo_no_ray": "diff",
        "nothing_wants_grad": "diff", "grid_sorted": "diff",
        "bwd_checkpoint": "diff", "primal": None, "vertices": None,
        "instance_transforms": None, "camera": None, "emission": None,
        "nee": None, "soft_primary": None, "grad_attached": None,
        "too_many_materials": None, "rr": None, "no_bounces": None,
        "glass": None, "brute": None, "unit": None}


@pytest.mark.parametrize("case", list(GATE))
def test_path_shade_entry_takes_albedo_only_gradients(scenes, case):
    """The gate takes a differentiable PALLAS render whose only gradient
    goes to ``mat_albedo`` (or to nothing), sorted lanes and checkpoints
    included, and declines the primal PALLAS render (the torch body, as
    before), vertex, instance-transform, camera and emission gradients,
    NEE, the soft primary, ``grad_attached``, more than DIFF_MAX_MATS
    materials, Russian roulette, zero bounces, glass and the plain
    traversals. It has no device term: these scenes are on the CPU."""
    scene, cfg, ray = _gate_case(scenes, case)
    assert shade.path_shade_entry(scene, cfg, ray) == GATE[case]


def _rays(scene, n, seed):
    """Rays from inside the demo room, 15% of them from outside it heading
    away (misses), 15% of the lanes inactive."""
    g = np.random.default_rng(seed)
    cb = scene.isect_chunk_bounds.numpy()
    lo, hi = cb[0:3].min(axis=1), cb[3:6].max(axis=1)
    o = g.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3)).T
    d = g.normal(size=(3, n))
    away = g.uniform(size=n) < 0.15
    o[:, away] = (hi + 1.0)[:, None]
    d[:, away] = np.abs(d[:, away])
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    ray = Ray(Vec3(*torch.from_numpy(o.astype(np.float32))),
              Vec3(*torch.from_numpy(d.astype(np.float32))))
    return ray, torch.from_numpy(g.uniform(size=n) < 0.85)


def _carry(scene, n=600, seed=0, grad=True):
    """One bounce's inputs on the demo: the hit ``trace_pallas_diff``
    found and recomputed, random throughput and radiance (leaves that
    require grad), PCG2D words, depth, steps, segments and first-hit
    normal."""
    g = np.random.default_rng(seed + 1)
    ray, active = _rays(scene, n, seed)
    hit = trace_pallas_diff(scene, ray, active)

    def f32(lo, hi, rows):
        x = torch.from_numpy(g.uniform(lo, hi, (rows, n)).astype(np.float32))
        return [r.clone().requires_grad_(grad) for r in x] if rows > 1 \
            else x[0]

    return dict(hit=hit, ray=ray, throughput=Vec3(*f32(0.0, 1.5, 3)),
                radiance=Vec3(*f32(0.0, 2.0, 3)), active=active,
                seed=tuple(torch.from_numpy(g.integers(0, 1 << 32, n))
                           for _ in range(2)),
                depth=f32(0.0, 1000.0, 1),
                steps=torch.from_numpy(g.integers(0, 1 << 20, n).astype(
                    np.int32)),
                segments=torch.from_numpy(g.integers(0, 5, n).astype(
                    np.int32)),
                normal=Vec3(*torch.from_numpy(g.normal(size=(3, n)).astype(
                    np.float32))))


def _body(scene, cfg, bounce, **c):
    """The loop body's statements for this case (render/integrator.py
    ``shade_bounce``), differentiated by autograd."""
    return integrator.shade_bounce(scene, c["hit"], c["ray"],
                                   c["throughput"], c["radiance"],
                                   c["active"], c["seed"], c["depth"],
                                   c["steps"], c["segments"], c["normal"],
                                   cfg, bounce)[0]


_flat = shade._flat


def _gaps(a: torch.Tensor, b: torch.Tensor):
    """(relative gap of norms, relative norm of the difference) per row of
    ``b`` whose norm is not 0; rows of 0 must be 0 in ``a`` too."""
    na, nb = a.norm(dim=-1), b.norm(dim=-1)
    zero = nb == 0
    assert bool((na[zero] == 0).all())
    return ((na - nb).abs()[~zero] / nb[~zero],
            (a - b).norm(dim=-1)[~zero] / nb[~zero])


@pytest.mark.parametrize("bounce", [0, 2])
def test_bounce_equals_the_torch_body(scenes, bounce):
    """One bounce through ``diff_bounce`` (its plain versions here) on a
    demo carry with misses, inactive lanes, back faces, the emitter and the
    metallic materials: every carry tensor equals the body's bit for bit
    and in dtype; the gradients of a random functional of the new
    throughput and radiance with respect to ``mat_albedo``, the old
    throughput and the old radiance are autograd's through the body within
    GRAD_RTOL per row; one Function node, no launch counted."""
    scene = _albedo_leaf(scenes["demo"])
    cfg = DIFF
    c = _carry(scene, seed=bounce)
    hit, active = c["hit"], c["active"]
    won = hit.hit & active
    mats = scene.isect_shade[hit.eidx.long(), 15].long()
    for kind in (active & ~hit.hit, ~active, won & ~hit.front,
                 won & (scene.mat_emission_energy[mats] > 0.0),
                 won & (scene.mat_metallic[mats] > 0.5)):
        assert bool(kind.any())
    before = (shade.path_shade_diff.launches,
              shade.path_shade_diff_bwd.launches)
    got = shade.diff_bounce(scene, shade.diff_tables(scene), config=cfg,
                            bounce=bounce, **c)
    want = _body(scene, cfg, bounce, **c)
    for k, (a, b) in enumerate(zip(_flat(got), _flat(want))):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach()), k
    assert 0 < int(got.active.sum()) < int(won.sum())
    assert type(got.throughput.x.grad_fn).__name__ == "PathShadeDiffBackward"
    w = torch.from_numpy(np.random.default_rng(5).normal(
        size=(6, active.shape[0])).astype(np.float32))
    leaves = (scene.mat_albedo, *c["throughput"], *c["radiance"])
    grads = []
    for out in (got, want):
        f = sum((x * w[k]).sum() for k, x in
                enumerate((*out.throughput, *out.radiance)))
        grads.append(torch.autograd.grad(f, leaves))
    assert (shade.path_shade_diff.launches,
            shade.path_shade_diff_bwd.launches) == before
    (ga, *gta), (gb, *gtb) = grads
    assert float(gb.norm(dim=1).min()) < float(gb.norm(dim=1).max())
    for gap in _gaps(ga, gb):
        assert float(gap.max()) <= GRAD_RTOL
    for gap in _gaps(torch.stack(gta).T, torch.stack(gtb).T):
        assert float(gap.max()) <= GRAD_RTOL


def test_forward_saves_what_the_backward_reads(scenes):
    """With ``save`` the plain forward also returns (9, n) rows and the
    lanes' material rows: the emission added (0 on inactive lanes), the
    throughput's factor (1 where the path ended, else new / old
    throughput) and k * throughput (0 where the path ended); the backward
    from them alone (``path_shade_diff_bwd``) is the Function's. Without
    ``save`` nothing is saved and the carry is the same."""
    scene = scenes["demo"]
    c = _carry(scene, seed=3, grad=False)
    tables = shade.diff_tables(scene)
    out, (saved, mat) = shade.path_shade_diff(scene, tables, config=DIFF,
                                              bounce=1, save=True, **c)
    out2, none = shade.path_shade_diff(scene, tables, config=DIFF, bounce=1,
                                       save=False, **c)
    assert none is None
    for a, b in zip(_flat(out), _flat(out2)):
        assert torch.equal(a, b)
    assert saved.shape == (9, 600) and mat.dtype == torch.int32
    active, survive = c["active"], out.active
    assert bool((saved[0:3, ~active] == 0).all())
    assert bool((saved[3:6, ~survive] == 1).all())
    assert bool((saved[6:9, ~survive] == 0).all())
    tp0 = torch.stack(list(c["throughput"]))
    torch.testing.assert_close(saved[3:6, survive] * tp0[:, survive],
                               torch.stack(list(out.throughput))[:, survive],
                               rtol=0, atol=0)
    g = [torch.ones(600) for _ in range(6)]
    g_tp, g_alb = shade.path_shade_diff_bwd(saved, mat, g[:3], g[3:],
                                            scene.mat_albedo.shape[0])
    assert g_tp.shape == (3, 600) and g_alb.shape == scene.mat_albedo.shape
    torch.testing.assert_close(g_tp, saved[0:3] + saved[3:6])


def _grid_seen(monkeypatch):
    """Wrap ``shade.path_shade_diff`` to tally, over its calls, the lanes
    that miss, are inactive, and hit a metallic material."""
    seen = {"calls": 0, "miss": 0, "dead": 0, "metal": 0}
    real = shade.path_shade_diff

    def spy(scene, tables, hit, ray, throughput, radiance, active, *a,
            **kw):
        seen["calls"] += 1
        seen["miss"] += int((active & ~hit.hit).sum())
        seen["dead"] += int((~active).sum())
        m = scene.isect_shade[hit.eidx.long(), 15].long()
        seen["metal"] += int((hit.hit & active
                              & (scene.mat_metallic[m] > 0.5)).sum())
        return real(scene, tables, hit, ray, throughput, radiance, active,
                    *a, **kw)

    monkeypatch.setattr(shade, "path_shade_diff", spy)
    return seen


def _render(scene, cam, cfg, frame, torch_body=False):
    """(AOVs, loss, albedo gradient) of a render of ``scene`` with a fresh
    albedo leaf: the MSE against a grey target, through the new path or
    (``torch_body``) the loop's torch body."""
    a = scene.mat_albedo.clone().requires_grad_(True)
    entry = integrator.path_shade_entry
    if torch_body:
        integrator.path_shade_entry = lambda *x: None
    try:
        aovs = render_radiance(replace_albedo(scene, a), cam, cfg, frame)
        loss = ((aovs.radiance - 0.3) ** 2).mean()
        (g,) = torch.autograd.grad(loss, a)
    finally:
        integrator.path_shade_entry = entry
    return aovs, loss.detach(), g


# (scene, RenderConfig changes, frame)
RENDERS = {
    "demo": ("demo", {}, 0),
    "demo_compacted_two_tiles": ("demo", {"compact_rays": True,
                                          "tile_rays": 256}, 1),
    "demo_checkpointed": ("demo", {"bwd_checkpoint": True}, 2),
    "demo_two_spp": ("demo", {"spp": 2, "bounces": 3}, 3),
    "grid_sorted": ("grid", {"sort_rays": True}, 1),
    "grid_sorted_checkpointed": ("grid", {"sort_rays": True,
                                          "bwd_checkpoint": True}, 2),
}


@pytest.mark.parametrize("case", list(RENDERS))
def test_render_equals_the_torch_body(scenes, case, monkeypatch):
    """A whole albedo-only differentiable render takes ``diff_bounce``
    once a tile, sample and bounce: every AOV and the loss equal the torch
    body's bit for bit, and the albedo gradient is autograd's through the
    body within GRAD_RTOL per row (the demo at 24x16: compacted lanes in
    two tiles, per-bounce checkpoints, two samples; the grid of 19 albedo
    rows at 16x12 with sorted lanes, with and without checkpoints). The
    lanes include misses, inactive lanes and metallic hits."""
    name, change, frame = RENDERS[case]
    scene = scenes[name]
    cam = tdemo.demo_camera(24, 16) if name == "demo" \
        else tdemo.grid_camera(16, 12, n=4)
    cfg = DIFF.replace(**change)
    want = _render(scene, cam, cfg, frame, torch_body=True)
    seen = _grid_seen(monkeypatch)
    got = _render(scene, cam, cfg, frame)
    n_pix = cam.width * cam.height
    tiles = -(-n_pix // cfg.tile_rays)
    ckpt = integrator.checkpoint_bounces(cfg, min(n_pix, cfg.tile_rays))
    assert seen["calls"] == tiles * cfg.spp * cfg.bounces * (2 if ckpt
                                                             else 1)
    assert seen["miss"] > 0 and seen["dead"] > 0 and seen["metal"] > 0
    for k in AOVS:
        a, b = getattr(got[0], k).detach(), getattr(want[0], k).detach()
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert torch.equal(got[1], want[1])
    for gap in _gaps(got[2], want[2]):
        assert float(gap.max()) <= GRAD_RTOL


def test_render_under_no_grad(scenes, monkeypatch):
    """Under no_grad the new path builds no node and saves nothing: the
    render equals the torch body's bit for bit and carries no graph."""
    scene = _albedo_leaf(scenes["demo"])
    cam = tdemo.demo_camera(16, 12)
    saves = []
    real = shade.path_shade_diff

    def spy(*a, **kw):
        saves.append(kw.get("save", a[-1] if a else None))
        return real(*a, **kw)

    monkeypatch.setattr(shade, "path_shade_diff", spy)
    with torch.no_grad():
        got = render_radiance(scene, cam, DIFF, 4)
        monkeypatch.setattr(integrator, "path_shade_entry", lambda *x: None)
        want = render_radiance(scene, cam, DIFF, 4)
    assert saves == [False] * DIFF.bounces
    for k in AOVS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.grad_fn is None and torch.equal(a, b), k


def test_launch_counters_stay_on_the_cpu(scenes):
    """On the CPU both wrappers run their plain versions and count no
    launch."""
    before = (shade.path_shade_diff.launches,
              shade.path_shade_diff_bwd.launches)
    _render(scenes["demo"], tdemo.demo_camera(16, 8), DIFF, 0)
    assert (shade.path_shade_diff.launches,
            shade.path_shade_diff_bwd.launches) == before


@pytest.mark.parametrize("fault", [
    "nee", "bvh", "bounce", "hit_rows", "hit_grad", "eidx_dtype",
    "steps_shape", "seed_dtype", "table_width", "table_grad", "device",
    "empty"])
def test_path_shade_diff_refuses(scenes, fault):
    """The forward wrapper raises, before any launch, on a config the gate
    declines, a bounce past the cap, a hit with winner rows or needing a
    gradient, operands of another dtype or shape, tables that are not
    ``diff_tables``, another device, and no lanes."""
    scene = scenes["demo"]
    c = _carry(scene, n=64, grad=False)
    cfg, bounce, tables = DIFF, 0, shade.diff_tables(scene)
    hit = c["hit"]
    if fault == "nee":
        cfg = cfg.replace(nee=True)
    elif fault == "bvh":
        cfg = cfg.replace(traversal=Traversal.BVH)
    elif fault == "bounce":
        bounce = cfg.bounces
    elif fault == "hit_rows":
        c["hit"] = hit._replace(rows=torch.zeros(48, 64))
    elif fault == "hit_grad":
        c["hit"] = hit._replace(u=hit.u.clone().requires_grad_())
    elif fault == "eidx_dtype":
        c["hit"] = hit._replace(eidx=hit.eidx.long())
    elif fault == "steps_shape":
        c["steps"] = c["steps"][:32]
    elif fault == "seed_dtype":
        c["seed"] = tuple(x.to(torch.int32) for x in c["seed"])
    elif fault == "table_width":
        tables = (tables[0][:, :12].contiguous(), tables[1])
    elif fault == "table_grad":
        tables = (tables[0], tables[1].clone().requires_grad_())
    elif fault == "device":
        c["active"] = c["active"].to("meta")
    elif fault == "empty":
        c["active"] = c["active"][:0]
    with pytest.raises(ValueError):
        shade.path_shade_diff(scene, tables, config=cfg, bounce=bounce,
                              save=True, **c)


@pytest.mark.parametrize("fault", ["no_mats", "too_many_mats", "saved_rows",
                                   "mat_dtype", "grad_shape", "empty"])
def test_path_shade_diff_bwd_refuses(fault):
    """The backward wrapper raises on a material count outside [1,
    DIFF_MAX_MATS] and on operands it cannot read."""
    n, n_mats = 32, 7
    saved, mat = torch.zeros(9, n), torch.zeros(n, dtype=torch.int32)
    g = [torch.zeros(n) for _ in range(6)]
    if fault == "no_mats":
        n_mats = 0
    elif fault == "too_many_mats":
        n_mats = shade.DIFF_MAX_MATS + 1
    elif fault == "saved_rows":
        saved = saved[:8]
    elif fault == "mat_dtype":
        mat = mat.long()
    elif fault == "grad_shape":
        g[4] = torch.zeros(n + 1)
    elif fault == "empty":
        saved, mat, g = saved[:, :0], mat[:0], [x[:0] for x in g]
    with pytest.raises(ValueError):
        shade.path_shade_diff_bwd(saved, mat, g[:3], g[3:], n_mats)


@pytest.fixture(scope="module")
def jax_interpret():
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    yield
    jip._FORCE_INTERPRET = old


def test_albedo_gradient_matches_jax(jax_interpret, scenes):
    """tests/test_torch_diff.py's slice with the albedo alone wanting a
    gradient, so the port shades through ``diff_bounce``: the gradient of
    sum(w · radiance) with respect to ``mat_albedo`` on JAX's 16×16 camera
    rays (2 bounces), over the pixels whose radiance agrees within 1e-5,
    rtol 1e-4 on components above 1% of the largest."""
    js = jax_demo_scene(texture_resolution=8, sphere_detail=6)
    ts = scenes["demo"]
    size = 16
    jcfg = JRenderConfig(bounces=2, traversal=JTraversal.PALLAS,
                         jitter=JJitter.NONE, differentiable=True,
                         regen=False)
    pids = jnp.arange(size * size, dtype=jnp.int32)
    seed = jrng.prng_seed((pids % size).astype(jnp.uint32),
                          (pids // size).astype(jnp.uint32), jnp.uint32(0))
    ray, seed = jax_demo_camera(size, size).generate_rays(pids, seed, jcfg)

    def jrad(alb):
        r = jax_path_trace(dataclasses.replace(js, mat_albedo=alb), ray,
                           seed, jcfg).radiance
        return jnp.stack([r.x, r.y, r.z])

    rad_j = np.asarray(jrad(js.mat_albedo))
    tray = Ray(Vec3(*(torch.from_numpy(np.array(x)) for x in ray.o)),
               Vec3(*(torch.from_numpy(np.array(x)) for x in ray.d)))
    tseed = tuple(torch.from_numpy(np.asarray(x).astype(np.int64))
                  for x in seed)
    cfg = RenderConfig(bounces=2, traversal=Traversal.PALLAS,
                       jitter=Jitter.NONE, differentiable=True, regen=False)
    alb = ts.mat_albedo.clone().requires_grad_(True)
    scene = replace_albedo(ts, alb)
    assert shade.path_shade_entry(scene, cfg, tray) == "diff"
    r = integrator.path_trace(scene, tray, tseed, cfg).radiance
    assert type(r.x.grad_fn).__name__ == "PathShadeDiffBackward"
    rad_p = torch.stack([r.x, r.y, r.z])
    ok = (np.abs(rad_p.detach().numpy() - rad_j) <= 1e-5).all(axis=0)
    assert ok.mean() >= 0.99, (~ok).sum()
    w = np.random.default_rng(1).uniform(size=rad_j.shape).astype(
        np.float32) * ok
    gj = np.asarray(jax.grad(lambda a: jnp.sum(jrad(a) * w))(js.mat_albedo))
    (gp,) = torch.autograd.grad((rad_p * torch.from_numpy(w)).sum(), alb)
    gp = gp.numpy()
    assert np.isfinite(gp).all() and np.abs(gj).max() > 0
    big = np.abs(gj) > 0.01 * np.abs(gj).max()
    np.testing.assert_allclose(gp[big], gj[big], rtol=1e-4)
