"""Ray sharding and fault recovery of the port (parallel/sharding.py,
parallel/fault.py) against single-device renders and against the JAX
package: the sharded frame equals the single-device standard loop's bit
for bit (BRUTE; PALLAS with and without NEE; 13x7, which pads) on gloo at
world size 1 in this process and at world sizes 2 and 3 in spawned
processes; the sharded albedo gradient equals the single one (rtol 1e-5,
atol 1e-7); the sharded frame agrees with JAX's render_radiance_sharded on
its 8-device CPU mesh; and tests/test_fault.py's four cases, on UNIT (the
reference's) and on PALLAS."""

from __future__ import annotations

import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gdpathtracing_tpu.config import Jitter as JJitter
from gdpathtracing_tpu.config import RenderConfig as JRenderConfig
from gdpathtracing_tpu.config import Traversal as JTraversal
from gdpathtracing_tpu.parallel.sharding import (
    make_mesh, render_radiance_sharded as jax_render_radiance_sharded)
from gdpathtracing_tpu.scene.demo import (
    build_cornell_simple as jax_cornell_simple,
    demo_camera as jax_demo_camera)

from gdpathtracing_torch.config import Jitter, RenderConfig, Traversal
from gdpathtracing_torch.parallel import (inject_tile_fault,
                                          redundancy_probe,
                                          render_radiance_sharded,
                                          render_with_retry, tile_health)
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

# The frames held bit for bit, sharded against single, the gradient's
# frame, and the sharded renders of a rank: shared with the spawned ranks,
# which run it as a script (without JAX), and executed here.
COMMON = r"""
import torch
from gdpathtracing_torch.config import Jitter, RenderConfig, Traversal
from gdpathtracing_torch.diff import image_mse, replace_albedo
from gdpathtracing_torch.parallel import render_radiance_sharded
from gdpathtracing_torch.scene.demo import build_cornell_simple, demo_camera

# name: (config, width, height)
FRAMES = {
    "brute": (RenderConfig(bounces=2, traversal=Traversal.BRUTE,
                           jitter=Jitter.UNIFORM), 13, 7),
    "pallas": (RenderConfig(bounces=2, traversal=Traversal.PALLAS,
                            regen=False, tile_rays=64), 13, 7),
    "pallas_nee": (RenderConfig(bounces=2, traversal=Traversal.PALLAS,
                                regen=False, nee=True, tile_rays=64), 13, 7),
}
GRAD = (RenderConfig(bounces=2, traversal=Traversal.PALLAS,
                     differentiable=True, tile_rays=256), 40, 24)


def _scene():
    return build_cornell_simple(device="cpu")


def _grad(render, scene, cfg, cam):
    # d image_mse(frame, 0) / d mat_albedo through `render`
    albedo = scene.mat_albedo.clone().requires_grad_(True)
    aovs = render(replace_albedo(scene, albedo), cam, cfg, 0)
    image_mse(aovs.radiance, torch.zeros_like(aovs.radiance)).backward()
    return albedo.grad


def sharded_results():
    # the sharded frames' AOVs ("<frame>/<aov>") and gradient ("grad") on
    # the current group, as NumPy arrays
    scene = _scene()
    out = {}
    for name, (cfg, w, h) in FRAMES.items():
        aovs = render_radiance_sharded(scene, demo_camera(w, h), cfg, 3)
        for k, v in aovs._asdict().items():
            out[f"{name}/{k}"] = v.detach().numpy()
    cfg, w, h = GRAD
    out["grad"] = _grad(render_radiance_sharded, scene, cfg,
                        demo_camera(w, h)).numpy()
    return out
"""
exec(COMMON)

# One rank of a spawned gloo group; rank 0 saves the results.
WORKER = r"""
import sys
sys.modules["jax"] = None
sys.modules["gdpathtracing_tpu"] = None
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
""" + COMMON + r"""
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
res = sharded_results()
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
"""


def _single_results() -> dict:
    scene = _scene()
    out = {}
    for name, (cfg, w, h) in FRAMES.items():
        aovs = render_radiance(scene, demo_camera(w, h), cfg, 3)
        for k, v in aovs._asdict().items():
            out[f"{name}/{k}"] = v.numpy()
    cfg, w, h = GRAD
    out["grad"] = _grad(render_radiance, scene, cfg,
                        demo_camera(w, h)).numpy()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def single():
    return _single_results()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Groups of world size 2 and 3 run at once, one process a rank."""
    d = tmp_path_factory.mktemp("sharded")
    procs = {}
    for world in (2, 3):
        port = _free_port()
        procs[world] = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world), str(port),
             str(d / f"w{world}.npz")], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    results = {}
    for world, ps in procs.items():
        logs = [p.communicate(timeout=300)[0] for p in ps]
        assert all(p.returncode == 0 for p in ps), "\n".join(logs)[-4000:]
        with np.load(d / f"w{world}.npz") as z:
            results[world] = dict(z)
    return results


@pytest.fixture(scope="module")
def group():
    """This process as a gloo group of one (the sharded renderer refuses
    to run before a group exists)."""
    with pytest.raises(RuntimeError, match="process group"):
        render_radiance_sharded(_scene(), demo_camera(4, 4),
                                FRAMES["brute"][0], 0)
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world1(group):
    return sharded_results()


def _assert_same(got: dict, want: dict):
    for k in want:
        if k == "grad":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7)
            assert np.abs(want[k]).max() > 0
        else:
            a, b = got[k], want[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype.kind == "f":  # bit for bit
                a, b = a.view(np.uint32), b.view(np.uint32)
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_sharded_world_size_1(world1, single):
    _assert_same(world1, single)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_spawned(spawned, single, world):
    _assert_same(spawned[world], single)


def test_sharded_matches_jax(group):
    """tests/test_sharding.py's BRUTE frame (40x24, 2 bounces, jittered,
    frame 3) on JAX's 8-device CPU mesh against the port's at world size 1
    (the 13x7 frames' equality across world sizes covers the rest): the
    image tolerance of tests/test_torch_render.py."""
    cfg, _, _ = FRAMES["brute"]
    got = render_radiance_sharded(_scene(), demo_camera(40, 24), cfg, 3)
    ref = jax_render_radiance_sharded(
        jax_cornell_simple(), jax_demo_camera(40, 24),
        JRenderConfig(bounces=2, traversal=JTraversal.BRUTE,
                      jitter=JJitter.UNIFORM), 3, make_mesh(jax.devices()))
    assert len(jax.devices()) == 8
    ok = np.isclose(got.radiance.numpy(), np.asarray(ref.radiance),
                    rtol=2e-3, atol=2e-3).all(axis=-1)
    assert ok.mean() >= 0.99, (~ok).sum()
    np.testing.assert_array_equal(got.segments.numpy()[ok],
                                  np.asarray(ref.segments)[ok])


# tests/test_fault.py's four cases, on UNIT (the reference's traversal)
# and on PALLAS through the standard loop, both bit for bit.
TILE = 16
FAULT_CONFIGS = {
    "unit": RenderConfig(bounces=2, traversal=Traversal.UNIT,
                         jitter=Jitter.NONE),
    "pallas": RenderConfig(bounces=2, traversal=Traversal.PALLAS,
                           jitter=Jitter.NONE, regen=False),
}


@pytest.fixture(scope="module")
def fault_scene():
    return build_demo_scene(texture_resolution=4, sphere_detail=6,
                            geometry="sphere", device="cpu"), \
        demo_camera(48, 32)


def _assert_frames_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
        if x.dtype == torch.float32:
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("trav", sorted(FAULT_CONFIGS))
def test_healthy_frame_skips_recovery(fault_scene, trav):
    scene, cam = fault_scene
    cfg = FAULT_CONFIGS[trav]
    clean = render_radiance(scene, cam, cfg, 0)
    assert tile_health(clean, TILE).all()
    aovs, recovered = render_with_retry(scene, cam, cfg, 0, render_radiance,
                                        tile=TILE)
    assert recovered == 0
    _assert_frames_equal(aovs, clean)


@pytest.mark.parametrize("kind", ["nan", "drop"])
@pytest.mark.parametrize("trav", sorted(FAULT_CONFIGS))
def test_injected_fault_healed_bit_identically(fault_scene, trav, kind):
    scene, cam = fault_scene
    cfg = FAULT_CONFIGS[trav]
    clean = render_radiance(scene, cam, cfg, 5)

    def faulty(scene, cam, cfg, f):
        return inject_tile_fault(render_radiance(scene, cam, cfg, f), 1, 2,
                                 TILE, kind)

    ok = tile_health(faulty(scene, cam, cfg, 5), TILE)
    assert not ok[1, 2] and ok.sum() == ok.size - 1
    retries = []
    aovs, recovered = render_with_retry(
        scene, cam, cfg, 5, faulty, tile=TILE,
        on_retry=lambda a, n: retries.append((a, n)))
    assert recovered == 1 and retries == [(0, 1)]
    _assert_frames_equal(aovs, clean)
    assert aovs.radiance.device == clean.radiance.device


@pytest.mark.parametrize("trav", sorted(FAULT_CONFIGS))
def test_silent_corruption_caught_by_probe(fault_scene, trav):
    scene, cam = fault_scene
    cfg = FAULT_CONFIGS[trav]
    clean = render_radiance(scene, cam, cfg, 7)
    corrupted = inject_tile_fault(clean, 1, 1, TILE, "silent")
    assert tile_health(corrupted, TILE).all()
    assert redundancy_probe(scene, cam, cfg, 7, corrupted, k=6,
                            tile=TILE) == [(1, 1)]
    assert redundancy_probe(scene, cam, cfg, 7, clean, k=6,
                            tile=TILE) == []

    def faulty(scene, cam, cfg, f):
        return inject_tile_fault(render_radiance(scene, cam, cfg, f), 1, 1,
                                 TILE, "silent")

    aovs, recovered = render_with_retry(scene, cam, cfg, 7, faulty,
                                        tile=TILE, probe_tiles=6)
    assert recovered == 1
    _assert_frames_equal(aovs, clean)


@pytest.mark.parametrize("trav", sorted(FAULT_CONFIGS))
def test_persistent_fault_bounded_by_max_retries(fault_scene, trav):
    scene, cam = fault_scene
    cfg = FAULT_CONFIGS[trav]

    def always_faulty(scene, cam, cfg, f):
        return inject_tile_fault(render_radiance(scene, cam, cfg, f), 0, 0,
                                 TILE, "nan")

    aovs, recovered = render_with_retry(scene, cam, cfg, 1, always_faulty,
                                        max_retries=2, tile=TILE)
    assert recovered == 1
    assert tile_health(aovs, TILE).all()
