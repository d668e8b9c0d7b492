"""The differentiable path of the port against the JAX package: the
differentiable traversal forms (ops/intersect.py ``trace_pallas_diff``,
``trace_occlude_pallas_diff``), ``path_trace`` with ``differentiable=True``
on JAX's own camera rays, the finite-difference checks of
tests/test_diff.py through PALLAS, the checkpoint settings and
diff/inverse.py. JAX's Pallas kernels run in interpret mode.

Inputs are made with numpy from fixed seeds (or are JAX's own camera rays)
and handed to both frameworks.
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
from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.diff.inverse import (
    replace_albedo as jax_replace_albedo,
    unbiased_mse_value_and_grad as jax_unbiased_mse_value_and_grad)
from gdpathtracing_tpu.render.integrator import path_trace as jax_path_trace
from gdpathtracing_tpu.render.types import Ray as JRay
from gdpathtracing_tpu.scene.demo import (build_demo_scene as jax_demo_scene,
                                          demo_camera as jax_demo_camera)

from gdpathtracing_torch.config import Jitter, RenderConfig, Traversal
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.diff.inverse import (image_mse, render_loss,
                                              replace_albedo,
                                              replace_camera_transform,
                                              replace_emission,
                                              replace_vertices,
                                              unbiased_mse_value_and_grad,
                                              value_and_grad_step)
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render import integrator
from gdpathtracing_torch.render.integrator import path_trace
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.render.types import MISS_T, Ray
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera,
                                            grid_camera)

torch.set_num_threads(1)
RES = 24  # tests/test_diff.py's resolution
DIFF = RenderConfig(bounces=2, spp=1, traversal=Traversal.PALLAS,
                    jitter=Jitter.NONE, differentiable=True)
# Values of the recompute epilogue against JAX's: t rtol 1e-6 + atol 1e-6
# and u/v atol 1e-5 (tests/test_torch_intersect.py: the same rounding of
# the same 4-term dots in another order); eidx equal but for 0.5% grazing
# ties.
T_RTOL, T_ATOL, UV_ATOL, MAX_EIDX_MISMATCH = 1e-6, 1e-6, 1e-5, 0.005
# VJPs of the epilogue: rtol 1e-5 on components above 1e-3 of the largest
# (sums over rays in another order), absolute 1e-6 of the largest below.
VJP_RTOL = 1e-5
# Gradients of the slice on the same rays: rtol 1e-4 on components above
# 1% of the largest (measured: <= 1e-6).
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _interpret():
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    yield
    jip._FORCE_INTERPRET = old


@pytest.fixture(scope="module")
def demo():
    js = jax_demo_scene(texture_resolution=8, sphere_detail=6)
    ts = build_demo_scene(texture_resolution=8, sphere_detail=6,
                          device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def spheres():
    """tests/test_diff.py's PALLAS scene: the demo room with spheres,
    whose interpolated normals make radiance smooth in the vertices."""
    return build_demo_scene(texture_resolution=4, sphere_detail=6,
                            geometry="sphere", device="cpu")


def _rays(n_random, seed):
    """Primary rays of a 32×16 demo camera, then random rays inside the
    room: (ox, oy, oz, dx, dy, dz) float32 numpy arrays."""
    cam = jax_demo_camera(32, 16)
    pids = jnp.arange(32 * 16, dtype=jnp.int32)
    s = jrng.prng_seed((pids % 32).astype(jnp.uint32),
                       (pids // 32).astype(jnp.uint32), jnp.uint32(7))
    ray, _ = cam.generate_rays(pids, s, JRenderConfig(
        jitter=JJitter.UNIFORM))
    g = np.random.default_rng(seed)
    o = g.uniform(-2.5, 2.5, (n_random, 3)).astype(np.float32)
    d = g.normal(size=(n_random, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [np.concatenate([np.asarray(getattr(ray.o, k)), o[:, i]])
            for i, k in enumerate("xyz")] + \
        [np.concatenate([np.asarray(getattr(ray.d, k)), d[:, i]])
         for i, k in enumerate("xyz")]


def _tray(cols, grad=False):
    t = [torch.from_numpy(c.copy()).requires_grad_(grad) for c in cols]
    return Ray(Vec3(*t[:3]), Vec3(*t[3:])), t


def _jray(cols):
    return JRay(JVec3(*map(jnp.asarray, cols[:3])),
                JVec3(*map(jnp.asarray, cols[3:])))


def _check_vjp(gp, gj):
    for a, b in zip(gp, gj):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all() and np.abs(b).max() > 0
        big = np.abs(b) > 1e-3 * np.abs(b).max()
        np.testing.assert_allclose(a[big], b[big], rtol=VJP_RTOL)
        np.testing.assert_allclose(a[~big], b[~big], rtol=0,
                                   atol=1e-6 * np.abs(b).max())


def _epilogue_case(demo, occlude):
    """trace_pallas_diff (or trace_occlude_pallas_diff, with shadow rays)
    against JAX's on demo rays, then the VJP of sum(a·t + b·u + c·v) with
    respect to isect_cols and the rays, with a, b, c zero where the
    winners differ."""
    js, ts = demo
    cols = _rays(100, 1)  # 612 rays: exercises the padding
    n = cols[0].shape[0]
    g = np.random.default_rng(2)
    active = g.uniform(size=n) < 0.8
    w = g.uniform(-1, 1, (3, n)).astype(np.float32)
    if occlude:
        sh = _rays(100, 3)
        sh_t = g.uniform(0.0, 4.0, n).astype(np.float32)
        sh_a = g.uniform(size=n) < 0.6

    def jtrace(c, o, d, ww):
        s = dataclasses.replace(js, isect_cols=c)
        ray = JRay(JVec3(*o), JVec3(*d))
        if occlude:
            h, occ = jip.trace_occlude_pallas_diff(
                s, ray, jnp.asarray(active), _jray(sh), jnp.asarray(sh_t),
                jnp.asarray(sh_a), interpret=True)
        else:
            h, occ = jip.trace_pallas_diff(s, ray, jnp.asarray(active),
                                           interpret=True), None
        loss = jnp.sum(ww[0] * jnp.where(h.t < MISS_T, h.t, 0.0)
                       + ww[1] * h.u + ww[2] * h.v)
        return loss, (h, occ)

    o0, d0 = jnp.asarray(np.stack(cols[:3])), jnp.asarray(np.stack(cols[3:]))
    _, (hj, occ_j) = jtrace(js.isect_cols, o0, d0, jnp.asarray(w))

    ray, leaves = _tray(cols, grad=True)
    c_t = ts.isect_cols.clone().requires_grad_(True)
    s = dataclasses.replace(ts, isect_cols=c_t)
    if occlude:
        shr, _ = _tray(sh)
        hp, occ_p = ti.trace_occlude_pallas_diff(
            s, ray, torch.from_numpy(active), shr, torch.from_numpy(sh_t),
            torch.from_numpy(sh_a))
        np.testing.assert_array_equal(occ_p.numpy(), np.asarray(occ_j))
        assert occ_p.any() and not occ_p[~torch.from_numpy(sh_a)].any()
    else:
        hp = ti.trace_pallas_diff(s, ray, torch.from_numpy(active))
    assert hp.rows is None and hp.t.requires_grad

    t_j, t_p = np.asarray(hj.t), hp.t.detach().numpy()
    np.testing.assert_allclose(t_p, t_j, rtol=T_RTOL, atol=T_ATOL)
    same = np.asarray(hj.eidx) == hp.eidx.numpy()
    assert (~same).mean() <= MAX_EIDX_MISMATCH, (~same).sum()
    assert (t_p[~active] == MISS_T).all()
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(hp, f).detach().numpy()[same],
                                   np.asarray(getattr(hj, f))[same],
                                   atol=UV_ATOL)
    for f in ("tri", "inst", "front"):
        np.testing.assert_array_equal(getattr(hp, f).numpy()[same],
                                      np.asarray(getattr(hj, f))[same])

    w = w * same
    gj = jax.grad(lambda *a: jtrace(*a, jnp.asarray(w))[0],
                  argnums=(0, 1, 2))(js.isect_cols, o0, d0)
    wt = torch.from_numpy(w)
    loss = (wt[0] * torch.where(hp.t < MISS_T, hp.t, 0.0) + wt[1] * hp.u
            + wt[2] * hp.v).sum()
    gp = torch.autograd.grad(loss, [c_t] + leaves)
    _check_vjp((gp[0], torch.stack(gp[1:4]), torch.stack(gp[4:7])), gj)


def test_trace_pallas_diff_matches_jax(demo):
    _epilogue_case(demo, occlude=False)


def test_trace_occlude_pallas_diff_matches_jax(demo):
    _epilogue_case(demo, occlude=True)


def test_kernels_refuse_operands_that_require_grad(demo):
    """A finder handed live (grad-requiring) rays raises on the CPU as it
    would on the card; the differentiable form detaches them itself."""
    _, ts = demo
    ray, _ = _tray(_rays(0, 0), grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        ti.trace_pallas(ts, ray)
    assert ti.trace_pallas_diff(ts, ray).t.requires_grad


# ---- the slice: path_trace on JAX's own rays --------------------------

@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_slice_albedo_emission_grads_match_jax(demo, nee):
    """Gradient of sum(w · radiance) with respect to mat_albedo and
    mat_emission, on JAX's 16×16 camera rays, over the pixels whose
    radiance agrees within 1e-5 (a pixel whose path diverges after a 1-ulp
    BRDF sample is masked out): rtol 1e-4 on components above 1% of the
    largest."""
    js, ts = demo
    size = 16
    jcfg = JRenderConfig(bounces=2, traversal=JTraversal.PALLAS,
                         jitter=JJitter.NONE, differentiable=True, nee=nee,
                         regen=False)
    pids = jnp.arange(size * size, dtype=jnp.int32)
    seed = jrng.prng_seed((pids % size).astype(jnp.uint32),
                          (pids // size).astype(jnp.uint32), jnp.uint32(0))
    ray, seed = jax_demo_camera(size, size).generate_rays(pids, seed, jcfg)

    def jrad(alb, em):
        r = jax_path_trace(dataclasses.replace(js, mat_albedo=alb,
                                               mat_emission=em),
                           ray, seed, jcfg).radiance
        return jnp.stack([r.x, r.y, r.z])

    rad_j = np.asarray(jrad(js.mat_albedo, js.mat_emission))
    tray = Ray(Vec3(*(torch.from_numpy(np.array(x)) for x in ray.o)),
               Vec3(*(torch.from_numpy(np.array(x)) for x in ray.d)))
    tseed = tuple(torch.from_numpy(np.asarray(x).astype(np.int64))
                  for x in seed)
    alb = ts.mat_albedo.clone().requires_grad_(True)
    em = ts.mat_emission.clone().requires_grad_(True)
    r = path_trace(dataclasses.replace(ts, mat_albedo=alb, mat_emission=em),
                   tray, tseed, RenderConfig(
                       bounces=2, traversal=Traversal.PALLAS,
                       jitter=Jitter.NONE, differentiable=True, nee=nee,
                       regen=False)).radiance
    rad_p = torch.stack([r.x, r.y, r.z])
    ok = (np.abs(rad_p.detach().numpy() - rad_j) <= 1e-5).all(axis=0)
    assert ok.mean() >= 0.99, (~ok).sum()
    w = np.random.default_rng(1).uniform(size=rad_j.shape).astype(
        np.float32) * ok
    gj = jax.grad(lambda a, e: jnp.sum(jrad(a, e) * w), argnums=(0, 1))(
        js.mat_albedo, js.mat_emission)
    gp = torch.autograd.grad((rad_p * torch.from_numpy(w)).sum(), (alb, em))
    for a, b in zip(gp, gj):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all() and np.abs(b).max() > 0
        big = np.abs(b) > 0.01 * np.abs(b).max()
        np.testing.assert_allclose(a[big], b[big], rtol=GRAD_RTOL)


# ---- renders: the PALLAS checks of tests/test_diff.py -------------------

def _fd_albedo(scene, cam, cfg, n_mats, min_checked):
    """jax.grad of the mean radiance against central differences on the
    largest albedo components: rel < 0.05 (test_diff.py: sampling is
    detached and seeds fixed, so only lobe-pick flips differ)."""
    def f(albedo):
        return render_radiance(replace_albedo(scene, albedo), cam, cfg,
                               0).radiance.mean()

    a0 = scene.mat_albedo.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(a0), a0)
    g = g.numpy()
    assert np.isfinite(g).all()
    eps, checked = 1e-3, 0
    for m in np.argsort(-np.abs(g).sum(axis=1))[:n_mats]:
        for c in range(3):
            if abs(g[m, c]) < 1e-5:
                continue
            with torch.no_grad():
                ap, am = scene.mat_albedo.clone(), scene.mat_albedo.clone()
                ap[m, c] += eps
                am[m, c] -= eps
                fd = (float(f(ap)) - float(f(am))) / (2 * eps)
            rel = abs(fd - g[m, c]) / max(abs(fd), abs(g[m, c]), 1e-8)
            assert rel < 0.05, (m, c, fd, g[m, c])
            checked += 1
    assert checked >= min_checked


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_pallas_diff_primal_parity_and_albedo_fd(spheres, nee):
    """test_diff.py::test_pallas_diff_gradient_matches_fd: the
    differentiable render's image equals the primal one (rtol 1e-5,
    atol 1e-6), and its albedo gradient matches central differences."""
    cam = demo_camera(RES, RES)
    cfg = DIFF.replace(nee=nee)
    prim = render_radiance(spheres, cam, cfg, 0).radiance
    base = render_radiance(spheres, cam, cfg.replace(differentiable=False),
                           0).radiance
    np.testing.assert_allclose(prim.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-6)
    _fd_albedo(spheres, cam, cfg, n_mats=2, min_checked=2)


def test_pallas_vertex_gradient_matches_fd(spheres):
    """test_diff.py::test_pallas_vertex_gradient_matches_fd: vertex
    gradients through update_vertices and the recompute epilogue with
    grad_attached (the exact chain rule of the primal estimator), on the
    pixels away from silhouettes; median rel < 0.05, all but one < 0.10."""
    cam = demo_camera(RES, RES)
    cfg = DIFF.replace(grad_attached=True)
    depth = render_radiance(spheres, cam, cfg, 0).depth.numpy()
    hitm = depth < 999.0
    interior = hitm.copy()
    for sy in (-1, 0, 1):
        for sx in (-1, 0, 1):
            interior &= np.roll(np.roll(hitm, sy, 0), sx, 1)
    w = torch.from_numpy(interior.astype(np.float32))[:, :, None]

    def f(tp):
        rad = render_radiance(replace_vertices(spheres, tp), cam, cfg,
                              0).radiance
        return (rad * w).sum() / w.sum()

    tp0 = spheres.tri_pos.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(tp0), tp0)
    g = g.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0
    eps, rels = 5e-3, []
    for ci in np.argsort(-np.abs(g).reshape(-1))[:24]:
        ti_, vi, xi = np.unravel_index(ci, g.shape)
        if abs(g[ti_, vi, xi]) < 1e-4:
            continue
        with torch.no_grad():
            tp, tm = spheres.tri_pos.clone(), spheres.tri_pos.clone()
            tp[ti_, vi, xi] += eps
            tm[ti_, vi, xi] -= eps
            fd = (float(f(tp)) - float(f(tm))) / (2 * eps)
        rels.append(abs(fd - g[ti_, vi, xi])
                    / max(abs(fd), abs(g[ti_, vi, xi]), 1e-8))
        if len(rels) >= 6:
            break
    assert len(rels) >= 4, rels
    good = sorted(rels)
    assert good[len(good) // 2] < 0.05, rels
    assert sum(r < 0.10 for r in good) >= len(rels) - 1, rels


def _albedo_grad(scene, cam, cfg):
    a0 = scene.mat_albedo.clone().requires_grad_(True)
    rad = render_radiance(replace_albedo(scene, a0), cam, cfg, 0).radiance
    (g,) = torch.autograd.grad(rad.mean(), a0)
    return g.numpy()


def test_bwd_checkpoint_paths_agree_and_auto_resolves(demo, monkeypatch):
    """test_diff.py::test_bwd_checkpoint_paths_agree_and_auto_resolves:
    bwd_checkpoint True, False and None (auto) give the same gradient
    (rtol 1e-6), also with the auto rule forced on by a 1-byte budget; the
    rule's arithmetic; and the recompute runs the finder again: twice the
    closest-hit calls of the run without checkpoints."""
    ts = demo[1]
    cam = demo_camera(RES, RES)
    calls = {"n": 0}
    plain = ti.closest_hit_rows_plain

    def counting(*a):
        calls["n"] += 1
        return plain(*a)

    monkeypatch.setattr(ti, "closest_hit_rows_plain", counting)
    grads = {}
    for name, kw in (("save", dict(bwd_checkpoint=False)),
                     ("ckpt", dict(bwd_checkpoint=True)), ("auto", {}),
                     ("forced", dict(bwd_resid_budget=1))):
        calls["n"] = 0
        grads[name] = _albedo_grad(ts, cam, DIFF.replace(**kw))
        grads[name + " calls"] = calls["n"]
    assert np.isfinite(grads["save"]).all() and \
        np.abs(grads["save"]).max() > 0
    for name in ("ckpt", "auto", "forced"):
        np.testing.assert_allclose(grads[name], grads["save"], rtol=1e-6,
                                   atol=1e-8, err_msg=name)
    assert grads["save calls"] == grads["auto calls"] == DIFF.bounces
    assert grads["ckpt calls"] == grads["forced calls"] == 2 * DIFF.bounces

    n = RES * RES
    assert not integrator.checkpoint_bounces(DIFF, n)
    assert integrator.checkpoint_bounces(DIFF.replace(bwd_resid_budget=1), n)
    # The frame-scope estimate at 1080p, 1 spp, 5 bounces: 2,097,152 lanes
    # × 5 × 160 B = 1.68 GB < 4 GiB, so no checkpoints.
    assert not integrator.checkpoint_bounces(DIFF.replace(bounces=5),
                                             8 * 262144)


def test_mid_grid_primal_parity_and_checkpoint(monkeypatch):
    """A superchunk scene (the mid grid: 34 chunks, kernel 3's plain
    version and the lite epilogue under the recompute): the differentiable
    image equals the primal one (rtol 1e-5, atol 1e-6), and checkpointed
    gradients equal the saved ones (rtol 1e-6)."""
    grid = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
    cam = grid_camera(16, 12, n=4)
    cfg = DIFF.replace(nee=True)
    got = render_radiance(grid, cam, cfg, 1).radiance
    want = render_radiance(grid, cam, cfg.replace(differentiable=False),
                           1).radiance
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    g_save = _albedo_grad(grid, cam, cfg.replace(bwd_checkpoint=False))
    g_ckpt = _albedo_grad(grid, cam, cfg.replace(bwd_checkpoint=True))
    assert np.isfinite(g_save).all() and np.abs(g_save).max() > 0
    np.testing.assert_allclose(g_ckpt, g_save, rtol=1e-6, atol=1e-8)


def test_regen_refuses_the_differentiable_path(demo):
    with pytest.raises(ValueError, match="regen"):
        render_radiance(demo[1], demo_camera(8, 8),
                        DIFF.replace(regen=True))


def test_emission_and_camera_gradients(demo):
    """test_diff.py's emission FD (radiance is linear in emission on fixed
    paths: rel < 1e-2) and a finite, non-zero camera-transform gradient."""
    ts = demo[1]
    cam = demo_camera(16, 16)

    def f(em):
        return render_radiance(replace_emission(ts, em), cam, DIFF,
                               0).radiance.mean()

    e0 = ts.mat_emission.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(e0), e0)
    m = int(torch.argmax(g.abs().sum(dim=1)))
    with torch.no_grad():
        ep, em_ = ts.mat_emission.clone(), ts.mat_emission.clone()
        ep[m, 0] += 1e-2
        em_[m, 0] -= 1e-2
        fd = (float(f(ep)) - float(f(em_))) / 2e-2
    assert abs(fd - float(g[m, 0])) / max(abs(fd), 1e-8) < 1e-2

    tf = cam.transform.clone().requires_grad_(True)
    rad = render_radiance(ts, replace_camera_transform(cam, tf), DIFF,
                          0).radiance
    (gc,) = torch.autograd.grad(rad.mean(), tf)
    assert bool(torch.isfinite(gc).all()) and float(gc.abs().max()) > 0


def test_value_and_grad_step_lowers_the_loss(demo):
    """test_diff.py::test_render_loss_and_optimization_step_decreases: one
    step on albedo against a darker target lowers the loss."""
    ts = demo[1]
    cam = demo_camera(16, 16)
    target = render_radiance(ts, cam, DIFF, 0).radiance.detach() * 0.5
    step = value_and_grad_step(replace_albedo, DIFF)
    l0, g = step(ts.mat_albedo, ts, cam, target)
    with torch.no_grad():
        l1 = render_loss(ts.mat_albedo - 0.5 * g, replace_albedo, ts, cam,
                         DIFF, target)
    assert float(l1) < float(l0)
    assert float(image_mse(target, target)) == 0.0


def test_unbiased_mse_value_and_grad_matches_jax(demo):
    """diff/inverse.py's decorrelated gradient against JAX's on the same
    frames, 16×16, 2 bounces: the loss within rtol 1e-5, the gradient
    within rtol 1e-4 on components above 1% of the largest. The frames
    (a, b) = (4, 18) are ones where every pixel's path agrees between the
    two packages: in most frames one or two of 256 pixels take another
    path after a 1-ulp difference in the camera ray or a BRDF sample
    (ROADMAP §3), which moves this image-wide gradient by up to a third."""
    js, ts = demo
    size = 16
    jcfg = JRenderConfig(bounces=2, traversal=JTraversal.PALLAS,
                         jitter=JJitter.NONE, differentiable=True)
    target = np.full((size, size, 3), 0.3, np.float32)
    lj, gj = jax_unbiased_mse_value_and_grad(
        js.mat_albedo, jax_replace_albedo, js, jax_demo_camera(size, size),
        jcfg, jnp.asarray(target), 4, 18)
    lp, gp = unbiased_mse_value_and_grad(
        ts.mat_albedo, replace_albedo, ts, demo_camera(size, size), DIFF,
        torch.from_numpy(target), 4, 18)
    gj, gp = np.asarray(gj), gp.numpy()
    np.testing.assert_allclose(float(lp), float(lj), rtol=1e-5)
    assert np.isfinite(gp).all() and np.abs(gj).max() > 0
    big = np.abs(gj) > 0.01 * np.abs(gj).max()
    np.testing.assert_allclose(gp[big], gj[big], rtol=GRAD_RTOL)
