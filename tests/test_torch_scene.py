"""Scene compilation of the port against the JAX package: every array of the
demo scene bit-equal, and scene_from_arrays round trips (the path by which
a JAX scene's arrays become a port scene)."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from gdpathtracing_tpu.scene.demo import build_demo_scene as jax_demo_scene

from gdpathtracing_torch.ops.intersect import prepare_trace_inputs
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera,
                                            grid_camera)
from gdpathtracing_torch.scene.scene import (Scene, scene_from_arrays,
                                             scene_to_arrays)

torch.set_num_threads(1)


def _jax_arrays(js) -> dict:
    return {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}


def _assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind == "f":  # bitwise, so -0.0 / NaN payloads count
            a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("geometry", ["reference", "sphere"])
def test_demo_scene_bit_equal_to_jax(geometry):
    js = jax_demo_scene(texture_resolution=8, sphere_detail=6,
                        geometry=geometry)
    ts = build_demo_scene(texture_resolution=8, sphere_detail=6,
                          geometry=geometry, device="cpu")
    _assert_bit_equal(scene_to_arrays(ts), _jax_arrays(js))


def test_demo_scene_size():
    s = build_demo_scene(texture_resolution=8, sphere_detail=6,
                         device="cpu")
    assert s.n_tris == 980 and s.n_lights == 970
    assert s.isect_mu.shape == (4, 2048)  # 8 chunks of 256: flat kernel
    assert tuple(s.textures.shape) == (1, 1, 1, 3) and not s.has_textures


def test_scene_from_arrays_round_trip():
    js = jax_demo_scene(texture_resolution=8, sphere_detail=6)
    from_jax = scene_from_arrays(_jax_arrays(js), device="cpu")
    assert isinstance(from_jax, Scene)
    _assert_bit_equal(scene_to_arrays(from_jax), _jax_arrays(js))
    again = scene_from_arrays(scene_to_arrays(from_jax), device="cpu")
    _assert_bit_equal(scene_to_arrays(again), scene_to_arrays(from_jax))
    assert again.n_lights == js.n_lights
    assert again.inst_tri_first == js.inst_tri_first
    with pytest.raises(KeyError):
        scene_from_arrays({k: v for k, v in _jax_arrays(js).items()
                           if k != "isect_mu"}, device="cpu")


def test_scene_to_device_keeps_values():
    s = build_demo_scene(texture_resolution=8, sphere_detail=6,
                         device="cpu")
    moved = s.to("cpu")
    assert moved.device == torch.device("cpu")
    assert torch.equal(moved.isect_mw, s.isect_mw)
    assert moved.n_lights == s.n_lights


def test_scenes_default_to_the_card():
    """With no device, scene construction targets cuda: where there is no
    card it raises rather than carrying on on the CPU."""
    js = jax_demo_scene(texture_resolution=8, sphere_detail=6)
    build = [lambda: build_demo_scene(texture_resolution=8),
             lambda: scene_from_arrays(_jax_arrays(js))]
    for make in build:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


def test_demo_camera_matches_jax():
    from gdpathtracing_tpu.scene.demo import demo_camera as jax_demo_camera
    jc, tc = jax_demo_camera(40, 24), demo_camera(40, 24)
    np.testing.assert_array_equal(tc.transform.numpy(),
                                  np.asarray(jc.transform))
    assert float(tc.fov_deg) == float(jc.fov_deg)
    assert (tc.width, tc.height, tc.near, tc.far) == \
        (jc.width, jc.height, jc.near, jc.far)


def test_demo_geometry_is_the_jax_asset():
    """The port reads its own copy of the demo geometry, byte-equal to the
    JAX package's."""
    import gdpathtracing_torch.scene.demo as tdemo
    import gdpathtracing_tpu.scene.demo as jdemo
    ours = Path(tdemo._GEOMETRY_NPZ)
    assert ours.parent.parent == Path(tdemo.__file__).resolve().parent
    theirs = Path(jdemo.__file__).resolve().parent / "data" / \
        "demo_geometry.npz"
    assert ours.read_bytes() == theirs.read_bytes()


# The sphere grids of the JAX bench (bench.py grid and mid axes, and a
# larger grid), with what the JAX package's prepare_trace_inputs makes of
# them: (n, sphere_detail) -> expanded triangles, chunks, superchunks of 8,
# bytes of the interleaved triangle rows, emissive triangles.
GRIDS = {(4, 12): (8704, 34, 5, 491520, 2),
         (10, 16): (96256, 376, 47, 4620288, 2),
         (14, 16): (188416, 736, 92, 9043968, 2)}


@pytest.mark.parametrize("n,detail", sorted(GRIDS), ids=str)
def test_sphere_grid_sizes(n, detail):
    s = build_sphere_grid(n=n, sphere_detail=detail, device="cpu")
    e, nc, nsc, m3_bytes, n_lights = GRIDS[(n, detail)]
    prep = prepare_trace_inputs(s)
    assert s.isect_mu.shape[1] == e and e // 256 == nc
    assert prep.superchunks and prep.sc_bounds.shape[1] == nsc
    assert prep.m3_bytes == m3_bytes and s.n_lights == n_lights


def test_sphere_grid_bit_equal_to_jax():
    from gdpathtracing_tpu.scene.demo import (
        build_sphere_grid as jax_sphere_grid, grid_camera as jax_grid_camera)
    js = jax_sphere_grid(n=4, sphere_detail=12)
    ts = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
    _assert_bit_equal(scene_to_arrays(ts), _jax_arrays(js))
    jc, tc = jax_grid_camera(16, 12, n=4), grid_camera(16, 12, n=4)
    np.testing.assert_array_equal(tc.transform.numpy(),
                                  np.asarray(jc.transform))
    assert float(tc.fov_deg) == float(jc.fov_deg)
