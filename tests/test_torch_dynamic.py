"""Dynamic scenes of the port (scene/dynamic.py) against the JAX package's:
``update_instance_transforms`` and ``update_vertices`` on the demo sphere
scene and on tests/test_silhouette.py's shadow scene, with perturbations
made by numpy from fixed seeds.

Tolerances: the Morton permutation (isect_tri, isect_inst, isect_light) is
equal; the rebuilt tables within rtol 1e-5 / atol 1e-6: the port inverts
each triangle's 3×3 frame by its adjugate, JAX by an LU solve, and the two
round differently in the last bits (measured: at most 3e-6 absolute on
values up to ~1e2).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdpathtracing_tpu.scene.demo import build_demo_scene as jax_demo_scene
from gdpathtracing_tpu.scene.dynamic import (
    morton_codes as jax_morton_codes,
    update_instance_transforms as jax_update_instance_transforms,
    update_vertices as jax_update_vertices)
from gdpathtracing_tpu.scene.materials import Material as JMaterial
from gdpathtracing_tpu.scene.primitives import plane_mesh as jax_plane_mesh
from gdpathtracing_tpu.scene.scene import SceneBuilder as JSceneBuilder

from gdpathtracing_torch.scene.demo import build_demo_scene
from gdpathtracing_torch.scene.dynamic import (morton_codes,
                                               update_instance_transforms,
                                               update_vertices)
from gdpathtracing_torch.scene.materials import Material
from gdpathtracing_torch.scene.primitives import plane_mesh
from gdpathtracing_torch.scene.scene import (SceneBuilder, scene_from_arrays,
                                             scene_to_arrays)

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
PERMUTED = ("isect_tri", "isect_inst", "isect_light")
TABLES = ("isect_mu", "isect_mv", "isect_mw", "isect_cols",
          "isect_chunk_bounds", "isect_shade", "tlas_min", "tlas_max",
          "inst_inv_transform", "node_min", "node_max")


def _affine(rows, origin):
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = np.asarray(rows, np.float32).reshape(3, 3)
    m[:, 3] = origin
    return m


def _shadow_scene(builder, material, plane, **build):
    b = builder()
    floor = b.add_mesh(plane(size=8.0))
    light = b.add_mesh(plane(size=2.0))
    blocker = b.add_mesh(plane(size=1.2))
    b.add_instance(floor, _affine([1, 0, 0, 0, 1, 0, 0, 0, 1], (0, 0, 0)),
                   materials=[material(albedo=(0.8, 0.8, 0.8))])
    b.add_instance(light, _affine([1, 0, 0, 0, -1, 0, 0, 0, -1], (0, 4, 0)),
                   materials=[material(emission=(1, 1, 1),
                                       emission_energy=10.0)])
    b.add_instance(blocker, _affine([1, 0, 0, 0, 1, 0, 0, 0, 1], (0, 2, 0)),
                   materials=[material(albedo=(0.2, 0.2, 0.2))])
    return b.build(**build)


@pytest.fixture(scope="module", params=["demo_spheres", "shadow"])
def scenes(request):
    if request.param == "demo_spheres":
        kw = dict(texture_resolution=4, sphere_detail=4, geometry="sphere")
        return jax_demo_scene(**kw), build_demo_scene(device="cpu", **kw)
    return (_shadow_scene(JSceneBuilder, JMaterial, jax_plane_mesh),
            _shadow_scene(SceneBuilder, Material, plane_mesh, device="cpu"))


def _compare(a, b):
    for f in PERMUTED:
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    for f in TABLES:
        got = getattr(b, f).detach().numpy()
        want = np.asarray(getattr(a, f))
        assert got.shape == want.shape, f
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f)


def test_morton_codes_match_jax():
    g = np.random.default_rng(0)
    p = g.uniform(-3, 5, (4096, 3)).astype(np.float32)
    lo, span = np.float32(-3.0), np.float32(8.0)
    want = np.asarray(jax_morton_codes(jnp.asarray(p), lo, span))
    got = morton_codes(torch.from_numpy(p), float(lo), float(span)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.max() < 2 ** 30


def test_update_instance_transforms_matches_jax(scenes):
    js, ts = scenes
    g = np.random.default_rng(1)
    tf = np.asarray(js.inst_transform) + g.normal(
        scale=0.05, size=js.inst_transform.shape).astype(np.float32)
    _compare(jax_update_instance_transforms(js, jnp.asarray(tf)),
             update_instance_transforms(ts, torch.from_numpy(tf)))


def test_update_vertices_matches_jax(scenes):
    js, ts = scenes
    g = np.random.default_rng(2)
    tp = np.asarray(js.tri_pos) + g.normal(
        scale=0.01, size=js.tri_pos.shape).astype(np.float32)
    _compare(jax_update_vertices(js, jnp.asarray(tp)),
             update_vertices(ts, torch.from_numpy(tp)))


def test_table_vjp_matches_jax(scenes):
    """The VJP of sum(w · isect_cols) + sum(w' · isect_shade) with respect
    to the transforms and the vertices against jax.vjp: rtol 1e-4 on
    components above 1e-3 of the largest (sums over many triangles in
    another order), finite everywhere."""
    js, ts = scenes
    g = np.random.default_rng(3)
    e = js.isect_cols.shape[0]
    w = g.uniform(-1, 1, (e, 12)).astype(np.float32)
    w2 = g.uniform(-1, 1, (e, 16)).astype(np.float32)

    def jf(tf, tp):
        s = jax_update_instance_transforms(
            dataclasses.replace(js, tri_pos=tp), tf)
        return jnp.sum(s.isect_cols * w) + jnp.sum(s.isect_shade * w2)

    gj = jax.grad(jf, argnums=(0, 1))(js.inst_transform, js.tri_pos)
    tf = ts.inst_transform.clone().requires_grad_(True)
    tp = ts.tri_pos.clone().requires_grad_(True)
    s = update_instance_transforms(dataclasses.replace(ts, tri_pos=tp), tf)
    loss = (s.isect_cols * torch.from_numpy(w)).sum() + \
        (s.isect_shade * torch.from_numpy(w2)).sum()
    gp = torch.autograd.grad(loss, (tf, tp))
    for a, b in zip(gp, gj):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all() and np.abs(b).max() > 0
        big = np.abs(b) > 1e-3 * np.abs(b).max()
        np.testing.assert_allclose(a[big], b[big], rtol=1e-4)


def test_scene_to_arrays_takes_a_scene_that_requires_grad(scenes):
    """scene_to_arrays detaches: a re-posed scene whose tables require grad
    round-trips through NumPy."""
    _, ts = scenes
    tf = ts.inst_transform.clone().requires_grad_(True)
    moved = update_instance_transforms(ts, tf)
    assert moved.isect_cols.requires_grad
    back = scene_from_arrays(scene_to_arrays(moved), device="cpu")
    assert torch.equal(back.isect_cols, moved.isect_cols.detach())
    assert back.tlas_refit_order == ts.tlas_refit_order
