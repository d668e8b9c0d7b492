"""Scene compilation of the port against the JAX package: every array of the
demo scene bit-equal, and scene_from_arrays round trips (the path by which
a JAX scene's arrays become a port scene)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from gdpathtracing_tpu.scene.demo import build_demo_scene as jax_demo_scene

from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera
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
