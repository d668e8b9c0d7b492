"""The port's scene loaders and native BVH builder against the JAX package:
OBJ (scene/objloader.py), Radiance HDR (scene/hdr.py), glTF and GLB
(scene/gltfloader.py), the JSON scene format (scene/sceneformat.py) and the
C++ SAH builder's binding (bvh/native.py, ``BLASBuilder(backend=...)``),
each on the same in-test files for both packages: equal surfaces, equal
scene tables, and a 16x16 UNIT render within the image tolerance of
tests/test_torch_render.py."""

from __future__ import annotations

import base64
import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

from gdpathtracing_tpu.bvh.blas import BLASBuilder as JBLASBuilder
from gdpathtracing_tpu.bvh.blas import Surface as JSurface
from gdpathtracing_tpu.cli import write_png as jax_write_png
from gdpathtracing_tpu.config import RenderConfig as JRenderConfig
from gdpathtracing_tpu.config import Traversal as JTraversal
from gdpathtracing_tpu.render.renderer import (
    render_radiance as jax_render_radiance)
from gdpathtracing_tpu.scene.gltfloader import GLTF as JGLTF
from gdpathtracing_tpu.scene.gltfloader import (
    load_gltf_scene as jax_load_gltf_scene)
from gdpathtracing_tpu.scene.hdr import load_hdr as jax_load_hdr
from gdpathtracing_tpu.scene.objloader import load_obj as jax_load_obj
from gdpathtracing_tpu.scene.sceneformat import (
    _decode_png as jax_decode_png, load_scene_file as jax_load_scene_file,
    parse_transform as jax_parse_transform)

from gdpathtracing_torch.bvh import native
from gdpathtracing_torch.bvh.blas import BLASBuilder, Surface, validate_blas
from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.scene.gltfloader import GLTF, load_gltf_scene
from gdpathtracing_torch.scene.hdr import load_hdr
from gdpathtracing_torch.scene.objloader import load_obj
from gdpathtracing_torch.scene.scene import scene_to_arrays
from gdpathtracing_torch.scene.sceneformat import (_decode_png,
                                                   load_scene_file,
                                                   parse_transform)

torch.set_num_threads(1)

# tests/test_scene.py:99-143's two OBJ files.
OBJ_QUADS = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
usemtl a
f 1/1/1 2/1/1 3/1/1 4/1/1
usemtl b
f 1/1/1 3/1/1 4/1/1
"""
OBJ_NEGATIVE = """
v 0 0 0
v 1 0 0
v 0 1 0
f -3 -2 -1
"""
# A box of two groups with uvs, for the JSON scene's OBJ mesh.
OBJ_BOX = """
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl floor
f 1/1 2/2 6/3 5/4
usemtl walls
f 1/1 4/2 3/3 2/4
f 5/1 6/2 7/3 8/4
f 1/1 5/2 8/3 4/4
"""

# tests/test_sceneformat.py's scene, with the OBJ box and a PNG texture.
SCENE = {
    "meshes": {
        "box": {"primitive": "cornell_box", "size": 5.0},
        "light": {"primitive": "plane", "size": 2.0},
        "ball": {"primitive": "uv_sphere", "radius": 1.0, "rings": 6,
                 "segments": 8},
        "crate": {"obj": "box.obj"},
    },
    "materials": {
        "grey": {"albedo": [1, 1, 1], "roughness": 0.6},
        "red": {"albedo": [1.0, 0.16, 0.16]},
        "green": {"albedo": [0.42, 1.0, 0.13]},
        "lamp": {"emission": [1, 1, 1], "emission_energy": 10},
        "mirror": {"metallic": 1.0, "roughness": 0.16},
        "tex": {"albedo": [1, 1, 1], "albedo_texture": "t.png"},
    },
    "instances": [
        {"mesh": "light", "materials": "lamp",
         "transform": {"position": [0, 2.95, 0],
                       "rotation_deg": [180, 0, 0]}},
        {"mesh": "box", "materials": ["grey", "red", "green"],
         "transform": {"rotation_deg": [0, 90, 0], "scale": 0.6}},
        {"mesh": "ball", "material_override": "mirror",
         "transform": {"position": [1.2, -1.0, -0.9]}},
        {"mesh": "crate", "materials": ["tex", "grey"],
         "transform": [0.5, 0, 0, -1.0, 0, 0.5, 0, -1.2, 0, 0, 0.5, 0.5]},
    ],
    "camera": {"position": [0, 0, 9.77], "look_at": [0, 0, 0], "fov": 79.5},
}


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return p


def _assert_surfaces_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("positions", "normals", "uvs"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def _assert_tables_equal(scene, jscene):
    """Every array of the port's scene bit-equal to the JAX scene's."""
    got = scene_to_arrays(scene)
    want = {f.name: np.asarray(getattr(jscene, f.name))
            for f in dataclasses.fields(jscene)}
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "f":
            a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
        np.testing.assert_array_equal(a, b, err_msg=k)


def _assert_unit_render_matches(scene, camera, jscene, jcamera):
    """16x16 UNIT frames, 2 bounces: radiance within 2e-3 on >= 99% of
    pixels and segments equal there (tests/test_torch_render.py)."""
    got = render_radiance(scene, camera, RenderConfig(
        traversal=Traversal.UNIT, bounces=2), 1)
    ref = jax_render_radiance(jscene, jcamera, JRenderConfig(
        traversal=JTraversal.UNIT, bounces=2), 1)
    ok = np.isclose(got.radiance.numpy(), np.asarray(ref.radiance),
                    rtol=2e-3, atol=2e-3).all(axis=-1)
    assert ok.mean() >= 0.99, (~ok).sum()
    np.testing.assert_array_equal(got.segments.numpy()[ok],
                                  np.asarray(ref.segments)[ok])
    assert got.segments.numpy().sum() >= 256


@pytest.mark.parametrize("text", [OBJ_QUADS, OBJ_NEGATIVE, OBJ_BOX],
                         ids=["quads_and_groups", "negative_indices",
                              "uv_box"])
def test_obj_matches_jax(tmp_path, text):
    p = _write(tmp_path, "m.obj", text)
    surfs = load_obj(str(p))
    assert all(isinstance(s, Surface) for s in surfs)
    _assert_surfaces_equal(surfs, jax_load_obj(str(p)))
    if text is OBJ_QUADS:  # test_scene.py's checks
        assert [s.n_tris for s in surfs] == [2, 1]
        assert np.allclose(surfs[0].normals, [0, 0, 1])
    if text is OBJ_NEGATIVE:  # the computed face normal is +z
        assert len(surfs) == 1 and np.allclose(surfs[0].normals, [0, 0, 1])


def _rle_hdr() -> bytes:
    """A 2x8 .hdr whose first scanline is new-style RLE (a run and a
    literal per channel) and whose second is flat."""
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 8\n"
    line = b"\x02\x02\x00\x08"
    for c in range(4):
        line += bytes([128 + 4, 100 + c]) + bytes([4, 1, 2, 3, 129 + c])
    flat = np.arange(32, dtype=np.uint8).reshape(8, 4) + 120
    return header + line + flat.tobytes()


def test_hdr_matches_jax(tmp_path):
    # tests/test_scene.py:182-200's flat 2x2 file, then an RLE one
    rgbe = np.array([[[128, 0, 0, 129], [0, 128, 0, 129]],
                     [[0, 0, 128, 129], [128, 128, 128, 130]]], np.uint8)
    p = tmp_path / "t.hdr"
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 2\n"
                  + rgbe.tobytes())
    img = load_hdr(p)
    assert img.shape == (2, 2, 3) and img.dtype == np.float32
    assert abs(img[0, 0, 0] - 1.004) < 0.01 and img[0, 0, 1] < 0.01
    assert abs(img[1, 1, 0] - 2.008) < 0.02
    np.testing.assert_array_equal(img, jax_load_hdr(p))
    q = tmp_path / "rle.hdr"
    q.write_bytes(_rle_hdr())
    img = load_hdr(q)
    assert img.shape == (2, 8, 3) and (img[0, :4] > 0).all()
    np.testing.assert_array_equal(img, jax_load_hdr(q))
    with pytest.raises(ValueError):
        load_hdr(_write(tmp_path, "bad.hdr", "P6\n"))


def _gltf_doc(embed: bool):
    """tests/test_gltf.py's quad (a node with translation and scale, a
    pbrMetallicRoughness material), plus an emissive second node, so a
    render of it has a light."""
    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                         np.float32)
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    indices = np.array([0, 1, 2, 2, 1, 3], np.uint16)
    buf = (positions.tobytes() + normals.tobytes() + uvs.tobytes()
           + indices.tobytes())
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0, "translation": [-1, -1, 0],
                   "scale": [2, 2, 2]},
                  {"mesh": 1, "translation": [-0.5, 0.5, 1.0],
                   "rotation": [0.0, 0.0, 0.0, 1.0]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]},
                   {"primitives": [{
                       "attributes": {"POSITION": 0}, "indices": 3,
                       "material": 1}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.5, 0.25, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.7}},
                      {"emissiveFactor": [1.0, 0.9, 0.8]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 48},
            {"buffer": 0, "byteOffset": 96, "byteLength": 32},
            {"buffer": 0, "byteOffset": 128, "byteLength": 12},
        ],
        "buffers": [{"byteLength": len(buf)}],
    }
    if embed:
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(buf).decode())
    return doc, buf


def _glb(doc, buf) -> bytes:
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    binchunk = buf + b"\x00" * (-len(buf) % 4)
    return (struct.pack("<III", 0x46546C67, 2,
                        12 + 8 + len(js) + 8 + len(binchunk))
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(binchunk), 0x004E4942) + binchunk)


@pytest.mark.parametrize("form", ["gltf", "glb"])
def test_gltf_matches_jax(tmp_path, form):
    doc, buf = _gltf_doc(embed=form == "gltf")
    p = tmp_path / f"quad.{form}"
    if form == "gltf":
        p.write_text(json.dumps(doc))
    else:
        p.write_bytes(_glb(doc, buf))
    g, jg = GLTF(p), JGLTF(p)
    for m in (0, 1):
        (surfs, mats), (jsurfs, jmats) = g.mesh_surfaces(m), \
            jg.mesh_surfaces(m)
        _assert_surfaces_equal(surfs, jsurfs)
        assert [dataclasses.astuple(x) for x in mats] == \
            [dataclasses.astuple(x) for x in jmats]
    assert mats[0].emission == (1.0, 0.9, 0.8)
    nodes, jnodes = g.node_transforms(), jg.node_transforms()
    assert [m for m, _ in nodes] == [m for m, _ in jnodes] == [0, 1]
    for (_, a), (_, b) in zip(nodes, jnodes):
        np.testing.assert_array_equal(a, b)
    assert np.allclose(nodes[0][1][:, 3], [-1, -1, 0])
    assert np.allclose(nodes[0][1][:, :3], np.eye(3) * 2)
    scene = load_gltf_scene(p, texture_resolution=4, device="cpu")
    jscene = jax_load_gltf_scene(p, texture_resolution=4)
    assert scene.n_tris == 4 and scene.n_instances == 2
    mat = scene.mat_albedo.numpy()[scene.inst_materials.numpy()[0, 0]]
    assert np.allclose(mat, [0.9, 0.5, 0.25])
    _assert_tables_equal(scene, jscene)


def test_gltf_render_matches_jax(tmp_path):
    from gdpathtracing_tpu.render.camera import Camera as JCamera
    from gdpathtracing_torch.render.camera import Camera
    doc, buf = _gltf_doc(embed=False)
    p = tmp_path / "quad.glb"
    p.write_bytes(_glb(doc, buf))
    kw = dict(fov_deg=60.0, width=16, height=16)
    _assert_unit_render_matches(
        load_gltf_scene(p, texture_resolution=4, device="cpu"),
        Camera.looking_at((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), **kw),
        jax_load_gltf_scene(p, texture_resolution=4),
        JCamera.looking_at((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), **kw))


def test_parse_transform_matches_jax():
    for spec in ([1, 0, 0, 5, 0, 1, 0, 6, 0, 0, 1, 7],
                 {"position": [1, 2, 3], "scale": 2.0},
                 {"rotation_deg": [0, 90, 0]},
                 {"rotation_deg": [10, 20, 30], "scale": [1, 2, 3],
                  "position": [4, 5, 6]}, None):
        t = parse_transform(spec)
        assert t.shape == (3, 4) and t.dtype == np.float32
        np.testing.assert_array_equal(t, jax_parse_transform(spec))
    t3 = parse_transform({"rotation_deg": [0, 90, 0]})
    assert np.allclose(t3[:, :3] @ np.array([0, 0, 1.0]), [1, 0, 0],
                       atol=1e-6)
    with pytest.raises(ValueError):
        parse_transform([1, 2, 3])


@pytest.fixture
def scene_dir(tmp_path):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 255, size=(16, 16, 3), dtype=np.uint8)
    jax_write_png(tmp_path / "t.png", img)
    _write(tmp_path, "box.obj", OBJ_BOX)
    _write(tmp_path, "scene.json", json.dumps(SCENE))
    return tmp_path, img


def test_scene_file_matches_jax(scene_dir):
    d, img = scene_dir
    np.testing.assert_array_equal(_decode_png((d / "t.png").read_bytes()),
                                  img)
    np.testing.assert_array_equal(
        _decode_png((d / "t.png").read_bytes()),
        jax_decode_png((d / "t.png").read_bytes()))
    scene, cam = load_scene_file(d / "scene.json", texture_resolution=8,
                                 width=64, height=48, device="cpu")
    jscene, jcam = jax_load_scene_file(d / "scene.json",
                                       texture_resolution=8, width=64,
                                       height=48)
    assert scene.n_instances == 4 and scene.has_textures
    assert (cam.width, cam.height, cam.near, cam.far) == (64, 48, 0.01,
                                                          1000.0)
    np.testing.assert_array_equal(cam.transform.numpy(),
                                  np.asarray(jcam.transform))
    assert float(cam.fov_deg) == float(jcam.fov_deg)
    mats = scene.inst_materials.numpy()
    assert scene.mat_metallic.numpy()[mats[2][0]] == 1.0
    assert np.allclose(scene.mat_albedo.numpy()[mats[1][1]],
                       [1.0, 0.16, 0.16])
    assert tuple(scene.textures.shape) == (1, 8, 8, 3)
    _assert_tables_equal(scene, jscene)


def test_scene_file_render_matches_jax(scene_dir):
    d, _ = scene_dir
    _assert_unit_render_matches(
        *load_scene_file(d / "scene.json", texture_resolution=8, width=16,
                         height=16, device="cpu"),
        *jax_load_scene_file(d / "scene.json", texture_resolution=8,
                             width=16, height=16))


# tests/test_native_bvh.py:23-77's cases: the native builder against the
# port's NumPy builder and against the JAX package's trees.
def _random_positions(rs, n_tris, scale=1.0, offset=0.0):
    v0 = rs.uniform(-1, 1, size=(n_tris, 3)) * scale + offset
    e1 = rs.uniform(-0.3, 0.3, size=(n_tris, 3))
    e2 = rs.uniform(-0.3, 0.3, size=(n_tris, 3))
    return np.stack([v0, v0 + e1, v0 + e2], axis=1).astype(np.float32)


TREE = ("node_min", "node_max", "node_left", "node_right", "node_first",
        "node_count", "tri_pos", "tri_normal", "tri_uv", "tri_slot")


def _build(builder, meshes, surface):
    roots = [builder.build_mesh([surface(positions=p)]) for p in meshes]
    return roots, builder.finalize()


def _assert_trees_equal(a, b):
    for k in TREE:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("case", ["16", "100", "977", "2048", "degenerate",
                                  "multi_mesh"])
def test_native_builder_bit_identical(case):
    assert native.available(), "the native builder does not build here"
    if case == "degenerate":
        meshes = [np.tile(np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]],
                                   np.float32), (33, 1, 1))]
    elif case == "multi_mesh":
        rs = np.random.RandomState(7)
        meshes = [_random_positions(rs, 60),
                  _random_positions(rs, 90, offset=3.0)]
    else:
        n = int(case)
        seed = {16: 0, 100: 1, 977: 2, 2048: 3}[n]
        meshes = [_random_positions(np.random.RandomState(seed), n)]
    b_nat = BLASBuilder(backend="native")
    r_nat, a_nat = _build(b_nat, meshes, Surface)
    b_np = BLASBuilder(backend="numpy")
    r_np, a_np = _build(b_np, meshes, Surface)
    b_jax = JBLASBuilder(backend="numpy")
    r_jax, a_jax = _build(b_jax, meshes, JSurface)
    assert r_nat == r_np == r_jax
    assert b_nat.mesh_tri_ranges == b_np.mesh_tri_ranges
    _assert_trees_equal(a_nat, a_np)
    _assert_trees_equal(a_nat, a_jax)
    for root in r_nat:
        validate_blas(a_nat, root)
    assert native.library_path().parent.name == "gdpathtracing_torch"


def test_blas_backend_choice(monkeypatch):
    """'auto' takes the native core where it builds and NumPy where it does
    not; 'native' then raises; an unknown backend is refused."""
    with pytest.raises(ValueError, match="backend"):
        BLASBuilder(backend="cuda")
    pos = _random_positions(np.random.RandomState(5), 40)
    want = _build(BLASBuilder(backend="numpy"), [pos], Surface)[1]
    calls = []
    real = native.build_blas_native
    monkeypatch.setattr(native, "build_blas_native",
                        lambda *a: calls.append(1) or real(*a))
    _assert_trees_equal(_build(BLASBuilder(), [pos], Surface)[1], want)
    assert calls == [1]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no toolchain")
    _assert_trees_equal(_build(BLASBuilder(), [pos], Surface)[1], want)
    assert calls == [1]
    with pytest.raises(RuntimeError, match="no toolchain"):
        BLASBuilder(backend="native").build_mesh([Surface(positions=pos)])
