"""The path-regeneration frame loop of the port (render/regen.py): against
the port's standard loop (the same per-path arithmetic and RNG streams, so
the frames agree), across its own variants (bit for bit), against JAX regen
and against the NEE golden image."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import gdpathtracing_tpu.ops.intersect_pallas as jip
from gdpathtracing_tpu.config import (Jitter as JJitter,
                                      RenderConfig as JRenderConfig,
                                      Traversal as JTraversal)
from gdpathtracing_tpu.render.regen import (
    render_radiance_regen as jax_render_radiance_regen)
from gdpathtracing_tpu.render.renderer import (
    render_radiance as jax_render_radiance)
from gdpathtracing_tpu.scene.demo import (build_demo_scene as jax_demo_scene,
                                          demo_camera as jax_demo_camera)

from gdpathtracing_torch.config import Jitter, RenderConfig, Traversal
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render import integrator, regen
from gdpathtracing_torch.render.regen import MAX_IT, render_radiance_regen
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera,
                                            grid_camera)

torch.set_num_threads(1)
DATA = Path(__file__).parent / "data"
W, H = 40, 24
BASE = RenderConfig(traversal=Traversal.PALLAS, bounces=3)
AOVS = ("radiance", "depth", "steps", "segments", "normal")
# Against JAX (another framework, whose tan/sin/cos round differently by
# an ulp, which can flip a shared-edge hit and so a whole path): the
# tolerance of tests/test_torch_render.py, 1e-4 on >= 99% of pixels.
MIN_PIXELS_OK = 0.99


@pytest.fixture(scope="module")
def scene():
    return build_demo_scene(texture_resolution=8, sphere_detail=6,
                            device="cpu")


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_regen_matches_standard_loop(scene, nee):
    """tests/test_regen.py's comparison, inside the port."""
    cam = demo_camera(W, H)
    cfg = BASE.replace(nee=nee)
    ref = render_radiance(scene, cam, cfg.replace(regen=False), 3)
    got = render_radiance(scene, cam, cfg, 3)  # regen=None: regen
    np.testing.assert_allclose(got.radiance.numpy(), ref.radiance.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.segments.numpy(),
                                  ref.segments.numpy())
    np.testing.assert_allclose(got.depth.numpy(), ref.depth.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(got.normal.numpy(), ref.normal.numpy(),
                               atol=1e-6)
    assert got.segments.numpy().sum() >= W * H


# (variant, what it is held against), each a change of BASE.
VARIANTS = {
    # many regeneration rounds: 256 lanes for 960 paths
    "wavefront": (dict(regen_wavefront=256), dict(regen=False)),
    "spp": (dict(spp=2), dict(spp=2, regen=False)),
    # the 3-way cumsum partition in place of the sorted permutation
    "partition": (dict(sort_rays=False), dict()),
    "scatter": (dict(regen_retire="scatter"), dict(regen_retire="log")),
    "no_compaction": (dict(compact_rays=False), dict()),
    "drain": (dict(regen_drain=True, regen_drain_wavefront=256),
              dict(regen_drain=False)),
}


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_regen_variants_bit_equal(scene, variant, nee):
    change, ref_change = VARIANTS[variant]
    cam = demo_camera(W, H)
    cfg = BASE.replace(nee=nee)
    got = render_radiance(scene, cam, cfg.replace(**change), 2)
    ref = render_radiance(scene, cam, cfg.replace(**ref_change), 2)
    for k in AOVS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k


def test_regen_stats(scene):
    cam = demo_camera(W, H)
    cfg = BASE.replace(regen_wavefront=512, regen_drain=True,
                       regen_drain_wavefront=256)
    render_radiance_regen.iterations = 0
    _, stats = render_radiance_regen(scene, cam, cfg, 1, return_stats=True)
    assert render_radiance_regen.iterations == stats["iters"]
    assert stats["n_blocks"] == 2
    # 960 paths through 512 lanes take more than one round; the drain
    # stage runs at 256 lanes.
    assert stats["iters"] > cfg.bounces
    assert 256 * stats["iters"] < stats["lane_slots"] < 512 * stats["iters"]


def test_regen_stats_match_jax(scene):
    """The per-iteration live lanes against JAX regen's (PALLAS in
    interpret mode) at 40x24, 3 bounces, frame 3, through 256 lanes and a
    drain: equal in every one of the MAX_IT slots. They depend only on how
    many segments each path traces, equal here on every pixel, not on the
    order in which the traversal visits chunks (unlike it_sweeps_a/b,
    test_regen_sweep_stats_are_the_rows_counters)."""
    change = dict(regen_wavefront=256, regen_drain=True,
                  regen_drain_wavefront=256)
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    try:
        ref, ref_stats = jax_render_radiance_regen(
            jax_demo_scene(texture_resolution=8, sphere_detail=6),
            jax_demo_camera(W, H),
            JRenderConfig(bounces=3, traversal=JTraversal.PALLAS, regen=True,
                          **change), 3, return_stats=True)
    finally:
        jip._FORCE_INTERPRET = old
    got, stats = render_radiance_regen(scene, demo_camera(W, H),
                                       BASE.replace(**change), 3,
                                       return_stats=True)
    np.testing.assert_array_equal(got.segments.numpy(),
                                  np.asarray(ref.segments))
    assert stats["iters"] == int(ref_stats["iters"]) > BASE.bounces
    assert stats["it_alive"].dtype == torch.int32
    assert stats["it_alive"].shape == (MAX_IT,)
    np.testing.assert_array_equal(stats["it_alive"].numpy(),
                                  np.asarray(ref_stats["it_alive"]))


def _mid_grid():
    return (build_sphere_grid(n=4, sphere_detail=12, device="cpu"),
            grid_camera(24, 16, n=4))


@pytest.mark.parametrize("where", ["flat", "superchunk rows", "lite"])
def test_regen_sweep_stats_are_the_rows_counters(scene, monkeypatch, where):
    """Slot i of it_alive, it_sweeps_a and it_sweeps_b holds iteration i's
    live lanes and the sums over its 256-lane blocks of rows 46 and 47 of
    the winner rows the traversal returned (recorded here around
    ``trace_pallas``), and the last slot the last iteration's once there
    are more than MAX_IT: on the demo (kernel 1: row 46 the chunks each
    block swept, row 47 0), on the mid grid through kernel 6 (``_SC_LITE``
    off: row 46 the superchunks each block entered, row 47 the chunks it
    swept, at least one a superchunk entered) and through kernel 3, whose
    raw winners regen hands to its shading (recorded around
    ``sc_lite_winners``) carry no rows (every sweep slot 0)."""
    if where == "flat":
        pscene, cam = scene, demo_camera(160, 128)
    else:
        pscene, cam = _mid_grid()
        monkeypatch.setattr(ti, "_SC_LITE", where == "lite")
    calls = []
    # (module, traversal, the position of its active mask)
    src, name, at = ((regen, "sc_lite_winners", 1) if where == "lite"
                     else (integrator, "trace_pallas", 2))
    trace = getattr(src, name)

    def recording(*a):
        hit = trace(*a)
        rows = None if where == "lite" else hit.rows
        calls.append((int(a[at].sum()),) + ((0.0, 0.0) if rows is None else
                                            tuple(rows[46:48, ::ti.BN].sum(
                                                dim=1).tolist())))
        return hit

    monkeypatch.setattr(src, name, recording)
    _, stats = render_radiance_regen(pscene, cam,
                                     BASE.replace(regen_wavefront=256), 1,
                                     return_stats=True)
    assert stats["iters"] == len(calls)
    want = np.zeros((3, MAX_IT))
    for i, c in enumerate(calls):
        want[:, min(i, MAX_IT - 1)] = c
    got = np.stack([stats[k].numpy() for k in ("it_alive", "it_sweeps_a",
                                               "it_sweeps_b")])
    np.testing.assert_array_equal(got, want)
    assert stats["it_sweeps_a"].dtype == torch.float32
    sweeps = np.array(calls)[:, 1:]
    if where == "flat":
        assert len(calls) > MAX_IT  # the last slot was overwritten
        assert not sweeps[:, 1].any() and sweeps[:, 0].max() > 0
        assert (sweeps[:, 0] <= 8).all()  # 8 chunks, one block
    elif where == "superchunk rows":
        assert (sweeps[:, 0] > 0).all()
        assert (sweeps[:, 1] >= sweeps[:, 0]).all()
    else:
        assert not sweeps.any()


def test_regen_sweep_stats_sum_each_blocks_first_lane(scene, monkeypatch):
    """The sweep stats on hand-set counters: rows 46 and 47 of every
    traversal replaced by (1000 * (block + 1) + lane in the block) and (7
    on a block's first lane, 1e6 on the others), through 512 lanes and a
    drain stage of 256: an iteration of b blocks sums 1000 * b(b+1)/2 and
    7b, whatever the other lanes hold."""
    trace = integrator.trace_pallas
    sizes = []

    def hand_set(*a):
        hit = trace(*a)
        rows = hit.rows.clone()
        lane = torch.arange(rows.shape[1])
        rows[46] = 1000.0 * (lane // ti.BN + 1) + lane % ti.BN
        rows[47] = torch.where(lane % ti.BN == 0, 7.0, 1e6)
        sizes.append(rows.shape[1] // ti.BN)
        return hit._replace(rows=rows)

    monkeypatch.setattr(integrator, "trace_pallas", hand_set)
    _, stats = render_radiance_regen(
        scene, demo_camera(W, H),
        BASE.replace(regen_wavefront=512, regen_drain=True,
                     regen_drain_wavefront=256), 2, return_stats=True)
    assert sizes[0] == 2 and sizes[-1] == 1  # a drain stage ran
    b = np.array(sizes, dtype=np.float64)
    n = len(sizes)
    np.testing.assert_array_equal(stats["it_sweeps_a"].numpy()[:n],
                                  1000.0 * b * (b + 1) / 2)
    np.testing.assert_array_equal(stats["it_sweeps_b"].numpy()[:n], 7.0 * b)
    assert not stats["it_sweeps_a"][n:].any()


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_regen_matches_jax(scene, nee):
    """The port's regen against JAX regen (PALLAS in interpret mode) at
    40x24, 3 bounces, frame 3: radiance within 1e-4 on >= 99% of pixels,
    segments equal there. ``steps`` depends on visit order and is not
    compared."""
    cfg_j = JRenderConfig(bounces=3, traversal=JTraversal.PALLAS, nee=nee,
                          regen=True)
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    try:
        ref = jax_render_radiance(
            jax_demo_scene(texture_resolution=8, sphere_detail=6),
            jax_demo_camera(W, H), cfg_j, 3)
    finally:
        jip._FORCE_INTERPRET = old
    got = render_radiance(scene, demo_camera(W, H), BASE.replace(nee=nee),
                          3)
    ok = (np.abs(got.radiance.numpy() - np.asarray(ref.radiance))
          <= 1e-4).all(axis=-1)
    assert ok.mean() >= MIN_PIXELS_OK, (~ok).sum()
    np.testing.assert_array_equal(got.segments.numpy()[ok],
                                  np.asarray(ref.segments)[ok])
    np.testing.assert_allclose(got.depth.numpy()[ok],
                               np.asarray(ref.depth)[ok], rtol=1e-5)


def test_golden_nee_16(scene):
    """tests/data/golden_nee_16.npz (NEE + MIS on JAX's UNIT backend, whose
    shadow test is a closest hit) at test_golden.py's tolerance, rtol =
    atol = 2e-3, rendered by the port's default loop (regen, any-hit shadow
    kernel). JAX's own PALLAS render of it misses that tolerance on 4 of
    the 256 pixels (the backends round the hit differently, which flips a
    few paths); the port may miss it on no more pixels than JAX's PALLAS
    render does, nor on more than 2%."""
    cfg = BASE.replace(spp=2, nee=True, jitter=Jitter.NONE)
    ref = np.load(DATA / "golden_nee_16.npz")["image"]
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    try:
        jax_img = np.asarray(jax_render_radiance(
            jax_demo_scene(texture_resolution=8, sphere_detail=6),
            jax_demo_camera(16, 16),
            JRenderConfig(bounces=3, spp=2, traversal=JTraversal.PALLAS,
                          nee=True, jitter=JJitter.NONE), 0).radiance)
    finally:
        jip._FORCE_INTERPRET = old
    img = render_radiance(scene, demo_camera(16, 16), cfg, 0).radiance
    assert img.shape == ref.shape == (16, 16, 3)

    def misses(x):
        return int((~np.isclose(x, ref, rtol=2e-3, atol=2e-3).all(-1)).sum())

    assert misses(img.numpy()) <= min(misses(jax_img), 0.02 * 256)


def test_regen_gate(scene):
    """What regen refuses, and where it ignores an option as the reference
    does: ``regen_march=True`` on the flat demo renders the frame without
    it (march_supported is false); fused NEE on a flat scene and the
    first-chunk key on sorted lanes render (they raised, naming ROADMAP
    queue 1, item 5, until it was ported): the fused frame equals the
    standard loop's and regen's unfused NEE frame, the chunk key's the
    default key's; a BVH render with regen=True raises the reference's
    ValueError (tests/test_torch_march.py renders the march and the
    options' fallbacks, tests/test_torch_regen_options.py the options)."""
    cam = demo_camera(8, 8)
    with pytest.raises(ValueError, match="regen"):
        render_radiance(scene, cam, BASE.replace(regen=True,
                                                 differentiable=True))
    # BRUTE takes regen (it raised until item 3 came in): the frame of its
    # standard loop, bit for bit.
    brute = BASE.replace(regen=True, traversal=Traversal.BRUTE)
    for a, b in zip(render_radiance(scene, cam, brute, 2),
                    render_radiance(scene, cam, brute.replace(regen=False),
                                    2)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="regen requires a primal"):
        render_radiance(scene, cam, BASE.replace(
            regen=True, traversal=Traversal.BVH))
    for change, ref in ((dict(nee=True, regen_fuse_nee=True),
                         dict(nee=True, regen=False)),
                        (dict(nee=True, regen_fuse_nee=True),
                         dict(nee=True)),
                        (dict(regen_sort_key="chunk"), dict()),
                        (dict(regen_march=True, regen_sort_key="chunk"),
                         dict())):
        got = render_radiance(scene, cam, BASE.replace(regen=True, **change),
                              2)
        want = render_radiance(scene, cam, BASE.replace(**ref), 2)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    march = render_radiance(scene, cam, BASE.replace(regen_march=True), 1)
    for a, b in zip(march, render_radiance(scene, cam, BASE, 1)):
        assert torch.equal(a, b)
