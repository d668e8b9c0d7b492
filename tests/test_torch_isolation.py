"""The port never imports JAX: a fresh interpreter in which ``import jax``
(and the JAX package) cannot succeed imports every module of
gdpathtracing_torch (diff/ and scene/dynamic.py among them) and renders
16x16 frames: the standard loop, the default regeneration loop with NEE,
a differentiable render with soft shadows through diff/'s re-posed
instances, whose transform gradient it takes, and the path kernels'
traversals (MEGA with NEE, FUSED); and a 16x12 frame of the mid grid
through regen's frontier march (kernel 7's plain version); the oracles
BRUTE (with Russian roulette) and UNIT (regen, with NEE), and two Engine
steps with temporal accumulation and the denoiser."""

from __future__ import annotations

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
leaked = [m for m in sys.modules if m.split(".")[0] in ("jaxlib",)
          or (m.startswith("gdpathtracing_tpu") and sys.modules[m] is not None)]
assert not leaked, leaked
print("MODULES", len(names))
"""


def test_port_imports_and_renders_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("MODULES")[1])
    assert n >= 21  # every module of the slice, csrc/ aside
