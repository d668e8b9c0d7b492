"""The port's command line (gdpathtracing_torch/cli.py, __main__.py) against
the JAX package's: ``render`` and ``info`` in a subprocess with ``--device
cpu``, ``info``'s JSON equal to JAX's on the same scene, and ``write_png``
byte-identical to JAX's."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gdpathtracing_tpu.cli import main as jax_main
from gdpathtracing_tpu.cli import write_png as jax_write_png

from gdpathtracing_torch.cli import main, write_png
from gdpathtracing_torch.scene.sceneformat import _decode_png

REPO = Path(__file__).resolve().parents[1]
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# tests/test_sceneformat.py's scene.
SCENE = {
    "meshes": {
        "box": {"primitive": "cornell_box", "size": 5.0},
        "light": {"primitive": "plane", "size": 2.0},
        "ball": {"primitive": "uv_sphere", "radius": 1.0, "rings": 6,
                 "segments": 8},
    },
    "materials": {
        "grey": {"albedo": [1, 1, 1], "roughness": 0.6},
        "red": {"albedo": [1.0, 0.16, 0.16]},
        "green": {"albedo": [0.42, 1.0, 0.13]},
        "lamp": {"emission": [1, 1, 1], "emission_energy": 10},
        "mirror": {"metallic": 1.0, "roughness": 0.16},
    },
    "instances": [
        {"mesh": "light", "materials": "lamp",
         "transform": {"position": [0, 2.95, 0],
                       "rotation_deg": [180, 0, 0]}},
        {"mesh": "box", "materials": ["grey", "red", "green"],
         "transform": {"rotation_deg": [0, 90, 0], "scale": 0.6}},
        {"mesh": "ball", "material_override": "mirror",
         "transform": {"position": [1.2, -1.0, -0.9]}},
    ],
    "camera": {"position": [0, 0, 9.77], "look_at": [0, 0, 0], "fov": 79.5},
}


def _cli(*args):
    """``python -m gdpathtracing_torch ARGS`` from the repository root."""
    return subprocess.run([sys.executable, "-m", "gdpathtracing_torch",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("scene", ["demo", "json"])
def test_cli_render(tmp_path, scene):
    if scene == "json":
        p = tmp_path / "scene.json"
        p.write_text(json.dumps(SCENE))
        scene = str(p)
    out = tmp_path / "img.png"
    res = _cli("render", scene, "--device", "cpu", "--out", str(out),
               "--width", "24", "--height", "16", "--frames", "2",
               "--bounces", "2", "--nee", "--tonemap", "reinhard")
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == str(out)
    assert "first frame" in res.stderr and "fps" in res.stderr
    data = out.read_bytes()
    assert data[:8] == PNG_SIGNATURE
    img = _decode_png(data)
    assert img.shape == (16, 24, 3) and img.dtype == np.uint8
    assert img.max() > 0


def test_cli_info_matches_jax(tmp_path, capsys):
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(SCENE))
    res = _cli("info", str(p), "--device", "cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout)
    jax_main(["info", str(p)])
    want = json.loads(capsys.readouterr().out)
    assert got == want
    assert sorted(got) == ["blas_nodes", "expanded_triangles", "instances",
                           "materials", "textures", "tlas_nodes",
                           "triangles"]
    assert got["instances"] == 3
    # in process, and the demo
    main(["info", "demo", "--device", "cpu"])
    demo = json.loads(capsys.readouterr().out)
    assert demo["triangles"] == 980 and demo["expanded_triangles"] == 2048


def test_cli_defaults_match_jax(monkeypatch):
    """The reference's flags and defaults (512x512, 8 frames, --traversal
    pallas, progressive, ACES), and --device, default cuda."""
    from gdpathtracing_tpu import cli as jax_cli
    from gdpathtracing_torch import cli

    seen = []
    for mod in (cli, jax_cli):
        monkeypatch.setattr(mod, "cmd_render",
                            lambda args: seen.append(vars(args)))
        mod.main(["render", "demo"])
    got, want = seen
    assert got.pop("device") == "cuda"
    got.pop("fn"), want.pop("fn")
    assert got == want
    assert got["width"] == got["height"] == 512 and got["frames"] == 8
    assert (got["traversal"], got["denoising"], got["tonemap"]) == (
        "pallas", "progressive", "aces")
    with pytest.raises(SystemExit):
        cli.main(["render", "demo", "--traversal", "nope"])


def test_write_png_byte_identical_to_jax(tmp_path):
    rs = np.random.RandomState(0)
    for shape in ((16, 16, 3), (7, 13, 3)):
        img = rs.randint(0, 255, size=shape, dtype=np.uint8)
        write_png(tmp_path / "a.png", img)
        jax_write_png(tmp_path / "b.png", img)
        a, b = (tmp_path / "a.png").read_bytes(), \
            (tmp_path / "b.png").read_bytes()
        assert a == b and a[:8] == PNG_SIGNATURE
        np.testing.assert_array_equal(_decode_png(a), img)
