"""The port never imports JAX: a fresh interpreter in which ``import jax``
(and the JAX package) cannot succeed imports every module of
gdpathtracing_torch (diff/ and scene/dynamic.py among them) and renders
16x16 frames: the standard loop, the default regeneration loop with NEE,
a differentiable render with soft shadows through diff/'s re-posed
instances, whose transform gradient it takes, and the path kernels'
traversals (MEGA with NEE, FUSED); and a 16x12 frame of the mid grid
through regen's frontier march (kernel 7's plain version); the oracles
BRUTE (with Russian roulette) and UNIT (regen, with NEE), two Engine
steps with temporal accumulation and the denoiser, regen's fused NEE and
first-chunk key, a JSON scene with an OBJ mesh and a PNG texture and a GLB
scene through the loaders (the BLAS through the native builder), a sharded
frame on a gloo group of one with a dropped tile healed, and the command
line (``python -m gdpathtracing_torch``, run as ``__main__``): ``info`` and
``render`` of that JSON scene."""

from __future__ import annotations

import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                 # any `import jax...` now raises
sys.modules["gdpathtracing_tpu"] = None
import torch
torch.set_num_threads(1)
import gdpathtracing_torch
names = [m.name for m in pkgutil.walk_packages(gdpathtracing_torch.__path__,
                                               "gdpathtracing_torch.")]
for name in names:
    if name != "gdpathtracing_torch.__main__":  # runs the CLI, below
        importlib.import_module(name)
from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera
scene = build_demo_scene(texture_resolution=8, sphere_detail=6, device="cpu")
aovs = render_radiance(scene, demo_camera(16, 16),
                       RenderConfig(traversal=Traversal.PALLAS, regen=False,
                                    bounces=2))
assert aovs.radiance.shape == (16, 16, 3)
assert bool(torch.isfinite(aovs.radiance).all())
assert int(aovs.segments.sum()) >= 16 * 16
nee = render_radiance(scene, demo_camera(16, 16),
                      RenderConfig(traversal=Traversal.PALLAS, nee=True,
                                   bounces=2))
assert bool(torch.isfinite(nee.radiance).all())
assert int(nee.segments.sum()) > int(aovs.segments.sum())  # shadow rays
from gdpathtracing_torch.diff import replace_instance_transforms
tf = scene.inst_transform.clone().requires_grad_(True)
diff = render_radiance(replace_instance_transforms(scene, tf),
                       demo_camera(16, 16),
                       RenderConfig(traversal=Traversal.PALLAS, nee=True,
                                    bounces=2, differentiable=True,
                                    soft_shadows=0.02))
(g,) = torch.autograd.grad(diff.radiance.mean(), tf)
assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
for cfg in (RenderConfig(traversal=Traversal.MEGA, nee=True, bounces=2),
            RenderConfig(traversal=Traversal.FUSED, bounces=2)):
    k = render_radiance(scene, demo_camera(16, 16), cfg)
    assert k.radiance.shape == (16, 16, 3)
    assert bool(torch.isfinite(k.radiance).all())
    assert int(k.segments.sum()) >= 16 * 16
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera
mid = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
march = RenderConfig(traversal=Traversal.PALLAS, bounces=2, regen_march=True)
plain = ti.march_step_sc_plain
rounds = []
ti.march_step_sc_plain = lambda *a: rounds.append(1) or plain(*a)
m = render_radiance(mid, grid_camera(16, 12, n=4), march)
assert rounds and bool(torch.isfinite(m.radiance).all())
assert int(m.segments.sum()) >= 16 * 12
for cfg in (RenderConfig(traversal=Traversal.BRUTE, bounces=4, rr_start=2),
            RenderConfig(traversal=Traversal.UNIT, bounces=2, nee=True,
                         regen=True)):
    o = render_radiance(scene, demo_camera(16, 16), cfg)
    assert bool(torch.isfinite(o.radiance).all())
    assert int(o.segments.sum()) >= 16 * 16
from gdpathtracing_torch import DenoisingMode, Engine
eng = Engine(scene, RenderConfig(traversal=Traversal.UNIT, bounces=2,
                                 denoising=DenoisingMode.TEMPORAL,
                                 spatial_denoise=True))
for _ in range(2):
    img = eng.step(demo_camera(16, 16))
assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
for cfg in (RenderConfig(traversal=Traversal.PALLAS, bounces=2, nee=True,
                         regen_fuse_nee=True),
            RenderConfig(traversal=Traversal.PALLAS, bounces=2,
                         regen_sort_key="chunk")):
    o = render_radiance(scene, demo_camera(16, 16), cfg)
    assert bool(torch.isfinite(o.radiance).all())
import json, os, runpy, struct, tempfile
from pathlib import Path
import numpy as np
from gdpathtracing_torch.bvh import native
from gdpathtracing_torch.cli import write_png
from gdpathtracing_torch.scene.gltfloader import load_gltf_scene
from gdpathtracing_torch.scene.sceneformat import load_scene_file
assert native.available()
d = Path(tempfile.mkdtemp())
(d / "box.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                           "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                           "f 1/1 2/2 3/3 4/4\n")
write_png(d / "t.png", np.full((4, 4, 3), 200, np.uint8))
(d / "s.json").write_text(json.dumps({
    "meshes": {"box": {"obj": "box.obj"},
               "light": {"primitive": "plane", "size": 2.0}},
    "materials": {"tex": {"albedo_texture": "t.png"},
                  "lamp": {"emission": [1, 1, 1], "emission_energy": 5}},
    "instances": [{"mesh": "box", "materials": ["tex"]},
                  {"mesh": "light", "materials": "lamp",
                   "transform": {"position": [0, 2, 1],
                                 "rotation_deg": [180, 0, 0]}}],
    "camera": {"position": [0.5, 0.5, 3]}}))
js, jcam = load_scene_file(d / "s.json", width=16, height=16, device="cpu")
assert js.has_textures
pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
doc = {"asset": {"version": "2.0"}, "meshes": [{"primitives": [{
    "attributes": {"POSITION": 0}}]}], "accessors": [{
    "bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"}],
    "bufferViews": [{"buffer": 0, "byteLength": 36}],
    "buffers": [{"byteLength": 36}]}
jsn = json.dumps(doc).encode()
jsn += b" " * (-len(jsn) % 4)
(d / "t.glb").write_bytes(struct.pack("<III", 0x46546C67, 2,
                                      12 + 16 + len(jsn) + 36)
                          + struct.pack("<II", len(jsn), 0x4E4F534A) + jsn
                          + struct.pack("<II", 36, 0x004E4942)
                          + pos.tobytes())
assert load_gltf_scene(d / "t.glb", device="cpu").n_tris == 1
import torch.distributed as dist
from gdpathtracing_torch.parallel import (inject_tile_fault,
                                          render_radiance_sharded,
                                          render_with_retry)
dist.init_process_group("gloo", init_method="tcp://localhost:"
                        + sys.argv[1], rank=0, world_size=1)
std = RenderConfig(traversal=Traversal.PALLAS, bounces=2, regen=False)
sh = render_radiance_sharded(js, jcam, std, 1)
healed, n = render_with_retry(
    js, jcam, std, 1, lambda *a: inject_tile_fault(
        render_radiance_sharded(*a), 0, 0, 8, "drop"), tile=8)
assert n == 1 and torch.equal(healed.radiance, sh.radiance)
dist.destroy_process_group()
for argv in (["info", str(d / "s.json")],
             ["render", str(d / "s.json"), "--width", "16", "--height",
              "16", "--frames", "2", "--bounces", "2", "--out",
              str(d / "o.png")]):
    sys.argv = ["gdpathtracing_torch", *argv, "--device", "cpu"]
    runpy.run_module("gdpathtracing_torch", run_name="__main__")
assert (d / "o.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
leaked = [m for m in sys.modules if m.split(".")[0] in ("jaxlib",)
          or (m.startswith("gdpathtracing_tpu") and sys.modules[m] is not None)]
assert not leaked, leaked
print("MODULES", len(names))
"""


def test_port_imports_and_renders_without_jax():
    with socket.socket() as s:  # a free port for the gloo group
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    proc = subprocess.run([sys.executable, "-c", SCRIPT, port], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert '"instances": 2' in proc.stdout  # info's JSON
    n = int(proc.stdout.split("MODULES")[1])
    assert n >= 21  # every module of the slice, csrc/ aside
