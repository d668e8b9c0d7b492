"""JSON scene description — the framework's user-facing scene format; port
of gdpathtracing_tpu/scene/sceneformat.py: the same host-side parsing, and
``load_scene_file`` builds the port's Scene on a device (the card unless
the caller asks for another) and returns the port's Camera.

Plays the role of the reference's Godot .tscn demo scene (demo.tscn:47-93):
declares meshes (OBJ files or built-in primitives), materials
(StandardMaterial3D-equivalent fields), instances with transforms and
per-surface material overrides, and a camera.

Example
-------
{
  "meshes": {
    "box":    {"obj": "geometry/cornell.obj"},
    "bunny":  {"primitive": "uv_sphere", "radius": 1.0}
  },
  "materials": {
    "red":    {"albedo": [1.0, 0.16, 0.16]},
    "light":  {"emission": [1, 1, 1], "emission_energy": 10},
    "mirror": {"metallic": 1.0, "roughness": 0.16},
    "wood":   {"albedo_texture": "textures/wood.png"}
  },
  "instances": [
    {"mesh": "box", "materials": [null, "red", "green"],
     "transform": {"position": [0, 0, 0], "rotation_deg": [0, 90, 0],
                   "scale": 0.6}}
  ],
  "camera": {"position": [0, 0, 9.77], "look_at": [0, 0, 0], "fov": 79.5}
}
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Tuple

import numpy as np

from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.scene import primitives
from gdpathtracing_torch.scene.materials import Material
from gdpathtracing_torch.scene.objloader import load_obj
from gdpathtracing_torch.scene.scene import Scene, SceneBuilder


def _rotation_matrix(deg) -> np.ndarray:
    """Euler XYZ (degrees) → 3x3, applied in X then Y then Z order."""
    rx, ry, rz = [math.radians(a) for a in deg]
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    return mz @ my @ mx


def parse_transform(spec) -> np.ndarray:
    """→ (3, 4) affine. Accepts a flat list of 12 numbers (row-major 3x4)
    or {position, rotation_deg, scale}."""
    if spec is None:
        return np.eye(4, dtype=np.float32)[:3]
    if isinstance(spec, (list, tuple)):
        arr = np.asarray(spec, dtype=np.float32)
        if arr.size == 12:
            return arr.reshape(3, 4)
        raise ValueError(f"transform list must have 12 numbers, got {arr.size}")
    m = np.eye(4, dtype=np.float32)[:3]
    rot = _rotation_matrix(spec.get("rotation_deg", (0, 0, 0)))
    scale = spec.get("scale", 1.0)
    if isinstance(scale, (int, float)):
        scale = (scale, scale, scale)
    m[:, :3] = rot * np.asarray(scale, dtype=np.float32)[None, :]
    m[:, 3] = spec.get("position", (0, 0, 0))
    return m


def _load_image(path: Path) -> np.ndarray:
    """Minimal PNG/PPM loader (RGB8). No imaging deps in the base image."""
    data = path.read_bytes()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return _decode_png(data)
    if data[:2] in (b"P6", b"P3"):
        raise ValueError("PPM not supported yet")
    raise ValueError(f"unsupported image format: {path}")


def _decode_png(data: bytes) -> np.ndarray:
    import struct
    import zlib
    pos = 8
    idat = b""
    w = h = bitd = ctype = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bitd, ctype = struct.unpack(">IIBB", chunk[:10])
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
    if bitd != 8 or ctype not in (2, 6):
        raise ValueError(f"only 8-bit RGB/RGBA PNGs supported (ctype={ctype})")
    nch = 3 if ctype == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * nch
    img = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    off = 0
    for y in range(h):
        f = raw[off]
        line = np.frombuffer(raw[off + 1:off + 1 + stride],
                             dtype=np.uint8).copy()
        off += 1 + stride
        if f == 1:  # Sub
            for x in range(nch, stride):
                line[x] = (int(line[x]) + int(line[x - nch])) & 0xFF
        elif f == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif f == 3:  # Average
            for x in range(stride):
                a = int(line[x - nch]) if x >= nch else 0
                line[x] = (int(line[x]) + ((a + int(prev[x])) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            for x in range(stride):
                a = int(line[x - nch]) if x >= nch else 0
                b = int(prev[x])
                c = int(prev[x - nch]) if x >= nch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (int(line[x]) + pred) & 0xFF
        img[y] = line
        prev = img[y]
    out = img.reshape(h, w, nch)[:, :, :3]
    return out


def load_scene_file(path: str | Path,
                    texture_resolution: int = 512,
                    width: int = 512, height: int = 512, device="cuda"
                    ) -> Tuple[Scene, Camera]:
    """Load a JSON scene file: (Scene on ``device``, Camera at
    ``width`` x ``height``)."""
    path = Path(path)
    spec = json.loads(path.read_text())
    base = path.parent

    builder = SceneBuilder(texture_resolution=texture_resolution)

    mesh_ids = {}
    for name, mspec in spec.get("meshes", {}).items():
        if isinstance(mspec, str):
            mspec = {"obj": mspec}
        if "obj" in mspec:
            surfaces = load_obj(str(base / mspec["obj"]))
        else:
            prim = mspec["primitive"]
            if prim == "uv_sphere":
                surfaces = primitives.uv_sphere(
                    radius=mspec.get("radius", 1.0),
                    rings=mspec.get("rings", 16),
                    segments=mspec.get("segments", 32))
            elif prim == "plane":
                surfaces = primitives.plane_mesh(size=mspec.get("size", 2.0))
            elif prim == "cornell_box":
                surfaces = primitives.cornell_box(size=mspec.get("size", 5.0))
            else:
                raise ValueError(f"unknown primitive {prim!r}")
        mesh_ids[name] = builder.add_mesh(surfaces)

    materials = {}
    for name, mat in spec.get("materials", {}).items():
        tex = None
        if "albedo_texture" in mat:
            tex = _load_image(base / mat["albedo_texture"])
        materials[name] = Material(
            albedo=tuple(mat.get("albedo", (1.0, 1.0, 1.0))),
            emission=tuple(mat.get("emission", (0.0, 0.0, 0.0))),
            emission_energy=mat.get("emission_energy", 0.0),
            metallic=mat.get("metallic", 0.0),
            roughness=mat.get("roughness", 1.0),
            albedo_texture=tex,
        )

    for inst in spec.get("instances", []):
        mats = inst.get("materials")
        if isinstance(mats, str):
            mats = materials[mats]
        elif isinstance(mats, list):
            mats = [materials[m] if m else None for m in mats]
        override = inst.get("material_override")
        builder.add_instance(
            mesh_ids[inst["mesh"]],
            parse_transform(inst.get("transform")),
            materials=mats,
            material_override=materials[override] if override else None)

    cam_spec = spec.get("camera", {})
    eye = cam_spec.get("position", (0.0, 0.0, 10.0))
    camera = Camera.looking_at(
        eye, cam_spec.get("look_at", (0.0, 0.0, 0.0)),
        cam_spec.get("up", (0.0, 1.0, 0.0)),
        fov_deg=cam_spec.get("fov", 79.5),
        width=width, height=height,
        near=cam_spec.get("near", 0.01), far=cam_spec.get("far", 1000.0))

    return builder.build(device), camera
