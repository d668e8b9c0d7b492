"""The frame loop of the port against the JAX package on the CPU: the
camera's rays for every jitter mode and its matrices, the post passes
(post/progressive.py, temporal.py, display.py, denoise.py, checkpoint.py;
tests/test_post.py's checks and the same numpy-seeded inputs through both
packages), render_frame and init_post_state, Engine
(tests/test_engine.py:17-68) and utils/stats.py."""

from __future__ import annotations

import enum
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdpathtracing_tpu.config as jconfig
from gdpathtracing_tpu import Engine as JEngine
from gdpathtracing_tpu.core import rng as jrng
from gdpathtracing_tpu.post.denoise import atrous_denoise as jax_atrous
from gdpathtracing_tpu.post.display import (bloom as jax_bloom,
                                            display_transform as jax_display)
from gdpathtracing_tpu.post.progressive import (
    progressive_init as jax_progressive_init,
    progressive_update as jax_progressive_update)
from gdpathtracing_tpu.post.temporal import (
    nonlinear_depth as jax_nonlinear_depth,
    temporal_init as jax_temporal_init,
    temporal_update as jax_temporal_update)
from gdpathtracing_tpu.render.camera import Camera as JCamera
from gdpathtracing_tpu.render.renderer import (
    init_post_state as jax_init_post_state, render_frame as jax_render_frame)
from gdpathtracing_tpu.scene.demo import (
    build_cornell_simple as jax_cornell, demo_camera as jax_demo_camera)

from gdpathtracing_torch import Engine, RenderConfig
from gdpathtracing_torch.config import DenoisingMode, Jitter, Tonemap, \
    Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.post.checkpoint import load_state, save_state
from gdpathtracing_torch.post.denoise import atrous_denoise
from gdpathtracing_torch.post.display import bloom, display_transform
from gdpathtracing_torch.post.progressive import (ProgressiveState,
                                                  progressive_init,
                                                  progressive_update)
from gdpathtracing_torch.post.temporal import (TemporalState,
                                               nonlinear_depth,
                                               temporal_init,
                                               temporal_update)
from gdpathtracing_torch.post.tonemap import aces_film
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.renderer import (init_post_state,
                                                 render_frame,
                                                 render_radiance)
from gdpathtracing_torch.scene.demo import build_cornell_simple, demo_camera
from gdpathtracing_torch.utils.stats import frame_stats, steps_heatmap
from gdpathtracing_torch.utils.telemetry import SPANS

torch.set_num_threads(1)
CFG = RenderConfig(bounces=2, spp=1, traversal=Traversal.UNIT)
# Frames against JAX's: tests/test_golden.py's tolerance on >= 99% of
# the pixels (a 1-ulp camera ray can send a path elsewhere, and the
# reprojection's inverse vp may round a pixel's source across a pixel
# boundary or its depth test across the threshold; ROADMAP §3) ...
IMG_TOL, MIN_PIXELS_OK = 2e-3, 0.99
# ... and on >= 95% after the à-trous denoiser, whose passes spread such a
# pixel over its neighbours (measured: 1 temporal pixel of 256 became 8).
MIN_DENOISED_OK = 0.95


def _j(cfg: RenderConfig):
    """The JAX RenderConfig of a port one (enums by name)."""
    return jconfig.RenderConfig(**{
        f: getattr(jconfig, type(v).__name__)[v.name]
        if isinstance(v, enum.Enum) else v
        for f, v in cfg.__dict__.items()})


def _orbit(k: int, size: int):
    """Both packages' cameras on the k-th step of an orbit about the
    Cornell room."""
    a = 0.08 * k
    eye = (9.7694 * np.sin(a), 0.3 * k, 9.7694 * np.cos(a))
    kw = dict(fov_deg=79.5, width=size, height=size)
    return (Camera.looking_at(eye, (0, 0, 0), **kw),
            JCamera.looking_at(eye, (0, 0, 0), **kw))


# ---- the camera -----------------------------------------------------------

@pytest.mark.parametrize("jitter", list(Jitter), ids=lambda j: j.name)
def test_camera_rays_match_jax(jitter):
    """generate_rays for each jitter mode, port against JAX, at 24x16,
    frames 0 and 7: seeds equal, origins and directions within 5e-7 (XLA's
    tan, sin, cos and log round differently by an ulp; measured 1.5e-7)."""
    w, h = 24, 16
    cfg = RenderConfig(jitter=jitter)
    for frame in (0, 7):
        pids = torch.arange(w * h)
        ray, seed = demo_camera(w, h).generate_rays(
            pids, rng.prng_seed(pids % w, pids // w, frame), cfg)
        jp = jnp.arange(w * h, dtype=jnp.int32)
        jray, jseed = jax_demo_camera(w, h).generate_rays(
            jp, jrng.prng_seed((jp % w).astype(jnp.uint32),
                               (jp // w).astype(jnp.uint32),
                               jnp.uint32(frame)), _j(cfg))
        for a, b in zip(seed, jseed):
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(b).astype(np.int64))
        for a, b in zip((*ray.o, *ray.d), (*jray.o, *jray.d)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=5e-7)


def test_camera_matrices_match_jax():
    """projection, view, vp and ivp against JAX's on the demo camera and an
    orbit camera; vp @ ivp is the identity."""
    for cam, jcam in ((demo_camera(64, 48), jax_demo_camera(64, 48)),
                      _orbit(3, 32)):
        for name in ("projection", "view", "vp", "ivp"):
            a = getattr(cam, name)().numpy()
            b = np.asarray(getattr(jcam, name)())
            assert a.shape == (4, 4)
            np.testing.assert_allclose(a, b, rtol=2e-6,
                                       atol=2e-6 * np.abs(b).max())
        np.testing.assert_allclose((cam.vp() @ cam.ivp()).numpy(),
                                   np.eye(4), atol=1e-3)


def test_camera_matrices_are_differentiable():
    cam = demo_camera(32, 24)
    fov = cam.fov_deg.clone().requires_grad_(True)
    tf = cam.transform.clone().requires_grad_(True)
    moved = Camera(tf, fov, cam.width, cam.height)
    g = torch.autograd.grad(moved.vp().sum() + moved.ivp().sum(), (tf, fov))
    assert all(bool(torch.isfinite(x).all()) for x in g)
    assert float(g[1].abs()) > 0


# ---- the post passes (tests/test_post.py) -------------------------------

def test_aces_range_and_monotone():
    y = aces_film(torch.linspace(0.0, 20.0, 100)).numpy()
    assert (y >= 0).all() and (y <= 1).all()
    assert (np.diff(y) >= -1e-6).all()
    assert y[-1] > 0.99
    assert float(aces_film(torch.tensor(0.0))) == 0.0


def test_progressive_accumulates_and_resets():
    state = progressive_init(4, 4, "cpu")
    tf = torch.zeros(3, 4)
    img1, state = progressive_update(state, torch.full((4, 4, 3), 1.0), tf)
    assert int(state.frame_count) == 1
    img2, state = progressive_update(state, torch.full((4, 4, 3), 3.0), tf)
    assert int(state.frame_count) == 2
    assert torch.allclose(img2, torch.full_like(img2, 2.0), atol=1e-6)
    moved = tf.clone()
    moved[0, 3] = 1.0
    _, state = progressive_update(state, torch.full((4, 4, 3), 5.0), moved)
    assert int(state.frame_count) == 1
    assert torch.allclose(state.accum, torch.full_like(state.accum, 5.0))


def test_progressive_matches_jax():
    g = np.random.default_rng(0)
    frames = g.uniform(0, 2, (3, 6, 5, 3)).astype(np.float32)
    tfs = [np.zeros((3, 4), np.float32)] * 2 + [np.ones((3, 4), np.float32)]
    s, js = progressive_init(5, 6, "cpu"), jax_progressive_init(5, 6)
    for f, tf in zip(frames, tfs):
        a, s = progressive_update(s, torch.from_numpy(f),
                                  torch.from_numpy(tf))
        b, js = jax_progressive_update(js, jnp.asarray(f), jnp.asarray(tf))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(s.frame_count) == int(js.frame_count)


def test_temporal_static_camera_blends_history():
    h = w = 4
    state = temporal_init(w, h, "cpu")
    vp = torch.eye(4)
    depth = torch.full((h, w), 0.5)
    _, state = temporal_update(state, torch.ones(h, w, 3), depth, vp)
    assert torch.allclose(state.history, torch.ones_like(state.history))
    _, state = temporal_update(state, torch.zeros(h, w, 3), depth, vp)
    assert torch.allclose(state.history,
                          torch.full_like(state.history, 0.75), atol=1e-5)


def test_temporal_reprojection_matches_jax():
    """Three frames of an orbiting camera's real view-projections over a
    plane at a slant: history taken from the reprojected nearest pixel
    where its depth agrees, as JAX takes it."""
    h, w = 12, 16
    g = np.random.default_rng(1)
    s, js = temporal_init(w, h, "cpu"), jax_temporal_init(w, h)
    lin = np.linspace(8.0, 14.0, w, dtype=np.float32)[None, :].repeat(h, 0)
    accepted = 0
    for k in range(3):
        cam, jcam = _orbit(k, w)
        cam = Camera(cam.transform, cam.fov_deg, w, h)
        jcam = JCamera.from_affine(np.asarray(jcam.transform), 79.5, w, h)
        rad = g.uniform(0, 1, (h, w, 3)).astype(np.float32)
        dnl = nonlinear_depth(torch.from_numpy(lin), cam.near, cam.far)
        jdnl = jax_nonlinear_depth(jnp.asarray(lin), jcam.near, jcam.far)
        np.testing.assert_allclose(dnl.numpy(), np.asarray(jdnl), rtol=1e-6)
        a, s = temporal_update(s, torch.from_numpy(rad), dnl, cam.vp())
        b, js = jax_temporal_update(js, jnp.asarray(rad), jdnl, jcam.vp())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        accepted += int((np.abs(a.numpy() - rad) > 1e-6).any(-1).sum())
    assert accepted > 0  # some history was reprojected and blended


def test_nonlinear_depth_reversed_z():
    near, far = 0.01, 1000.0
    d = nonlinear_depth(torch.tensor([near, far]), near, far)
    assert abs(float(d[0])) < 1e-4
    assert abs(float(d[1]) - (far / (far - near) * (1 - near / far))) < 1e-4


def test_display_transform_modes():
    img = torch.full((8, 8, 3), 0.5)
    aces = display_transform(img, RenderConfig())
    lin = display_transform(img, RenderConfig(tonemap=Tonemap.LINEAR))
    rein = display_transform(img, RenderConfig(tonemap=Tonemap.REINHARD))
    assert torch.allclose(lin, torch.full_like(lin, 0.5))
    assert torch.allclose(rein, torch.full_like(rein, 0.5 / 1.5), atol=1e-6)
    assert not torch.allclose(aces, lin)
    ex = display_transform(img, RenderConfig(tonemap=Tonemap.LINEAR,
                                             exposure=2.0))
    assert torch.allclose(ex, torch.ones_like(ex))


def test_bloom_spreads_highlights():
    img = torch.zeros(17, 17, 3)
    img[8, 8] = 20.0
    out = bloom(img, threshold=1.0, strength=0.5, radius=4)
    assert out[8, 8, 0] > 20.0
    assert out[8, 10, 0] > 0.01
    assert out[0, 0, 0] < 1e-4


@pytest.mark.parametrize("tonemap", list(Tonemap), ids=lambda t: t.name)
def test_display_and_bloom_match_jax(tonemap):
    img = np.random.default_rng(2).gamma(1.0, 1.0, (9, 13, 3)).astype(
        np.float32)
    cfg = RenderConfig(tonemap=tonemap, exposure=1.5, bloom=True,
                       bloom_threshold=1.0, bloom_strength=0.3,
                       bloom_radius=3)
    np.testing.assert_allclose(
        bloom(torch.from_numpy(img), 1.0, 0.3, 3).numpy(),
        np.asarray(jax_bloom(jnp.asarray(img), 1.0, 0.3, 3)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        display_transform(torch.from_numpy(img), cfg).numpy(),
        np.asarray(jax_display(jnp.asarray(img), _j(cfg))), atol=1e-6)


def _denoise_inputs():
    rs = np.random.RandomState(0)
    h = w = 32
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, w // 2:] = 1.0
    noisy = clean + rs.normal(0, 0.2, size=clean.shape).astype(np.float32)
    normal = np.zeros((h, w, 3), np.float32)
    normal[:, : w // 2, 2] = 1.0
    normal[:, w // 2:, 0] = 1.0
    depth = np.where(np.arange(w)[None, :] < w // 2, 5.0, 10.0)
    depth = np.broadcast_to(depth, (h, w)).astype(np.float32)
    return noisy, normal, depth


def test_atrous_denoiser_reduces_noise_keeps_edges():
    noisy, normal, depth = _denoise_inputs()
    h, w = depth.shape
    out = atrous_denoise(*map(torch.from_numpy, (noisy, normal,
                                                 depth))).numpy()
    left = slice(4, h - 4), slice(4, w // 2 - 4)
    right = slice(4, h - 4), slice(w // 2 + 4, w - 4)
    assert out[left].std() < 0.5 * noisy[left].std()
    assert out[right].std() < 0.5 * noisy[right].std()
    assert out[right].mean() - out[left].mean() > 0.8


@pytest.mark.parametrize("size", [(32, 32), (6, 20)], ids=["32x32", "6x20"])
def test_atrous_denoiser_matches_jax(size):
    """On the edge case too: a 6-row image, where the third pass's shift
    of 8 rows wraps and its edge fill clamps, as the reference's does."""
    noisy, normal, depth = _denoise_inputs()
    h, w = size
    args = [np.ascontiguousarray(x[:h, :w]) for x in (noisy, normal, depth)]
    np.testing.assert_allclose(
        atrous_denoise(*map(torch.from_numpy, args)).numpy(),
        np.asarray(jax_atrous(*map(jnp.asarray, args))), rtol=1e-5,
        atol=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    state = ProgressiveState(accum=torch.arange(12.0).reshape(2, 2, 3),
                             frame_count=torch.tensor(7, dtype=torch.int32),
                             prev_transform=torch.ones(3, 4))
    p = tmp_path / "ckpt.npz"
    save_state(p, state)
    like = ProgressiveState(torch.zeros(2, 2, 3),
                            torch.tensor(0, dtype=torch.int32),
                            torch.zeros(3, 4))
    back = load_state(p, like)
    assert isinstance(back, ProgressiveState)
    assert int(back.frame_count) == 7
    assert back.frame_count.dtype == torch.int32
    assert torch.equal(back.accum, torch.arange(12.0).reshape(2, 2, 3))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_state(p, temporal_init(2, 2, "cpu"))


# ---- render_frame and Engine (tests/test_engine.py:17-68) -----------------

def test_engine_progressive_accumulates():
    eng = Engine(build_cornell_simple(device="cpu"), CFG)
    cam = demo_camera(24, 24)
    img1 = eng.step(cam).numpy()
    assert img1.shape == (24, 24, 3)
    assert (img1 >= 0).all() and (img1 <= 1).all()
    for _ in range(3):
        img = eng.step(cam)
    assert eng.frame_index == 4
    assert int(eng._state.frame_count) == 4
    assert eng.to_uint8(img).dtype == np.uint8


def test_engine_reset_on_new_camera_is_manual():
    eng = Engine(build_cornell_simple(device="cpu"),
                 CFG.replace(denoising=DenoisingMode.NONE))
    img = eng.step(demo_camera(16, 16))
    assert bool(torch.isfinite(img).all())
    assert eng._state is None


def test_frame_stats_and_heatmap():
    aovs = render_radiance(build_cornell_simple(device="cpu"),
                           demo_camera(16, 16), CFG, 0)
    st = frame_stats(aovs, spp=1, elapsed_s=1.0)
    assert st.rays > 16 * 16
    assert 1.0 <= st.mean_path_length <= CFG.bounces
    assert st.mrays_per_s == st.rays / 1e6
    hm = steps_heatmap(aovs).numpy()
    assert hm.shape == (16, 16, 3)
    assert (hm >= 0).all() and (hm <= 1).all()


@pytest.mark.parametrize("mode", [DenoisingMode.NONE,
                                  DenoisingMode.PROGRESSIVE,
                                  DenoisingMode.TEMPORAL],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("spatial", [False, True], ids=["", "denoised"])
def test_render_frame_matches_jax(mode, spatial):
    """init_post_state and three render_frame steps under an orbiting
    camera (UNIT on the Cornell room, 16x16): each image and the state
    against JAX's."""
    cfg = CFG.replace(denoising=mode, spatial_denoise=spatial)
    jcfg = _j(cfg)
    scene, jscene = build_cornell_simple(device="cpu"), jax_cornell()
    cam0, jcam0 = _orbit(0, 16)
    state = init_post_state(cam0, cfg, "cpu")
    jstate = jax_init_post_state(jcam0, jcfg)
    assert type(state).__name__ == type(jstate).__name__
    for k in range(3):
        cam, jcam = _orbit(k, 16)
        img, state = render_frame(scene, cam, cfg, state, k)
        jimg, jstate = jax_render_frame(jscene, jcam, jcfg, jstate, k)
        assert img.shape == (16, 16, 3)
        ok = np.isclose(img.numpy(), np.asarray(jimg), rtol=IMG_TOL,
                        atol=IMG_TOL).all(-1)
        assert ok.mean() >= (MIN_DENOISED_OK if spatial else MIN_PIXELS_OK
                             ), (k, int((~ok).sum()))
    if state is not None:
        assert int(state.frame_count) == int(jstate.frame_count)


def test_engine_temporal_matches_jax():
    """Engine's four TEMPORAL steps with the spatial denoiser under an
    orbiting camera against JAX's render_frame steps. (JAX's own Engine
    cannot take them: under its jax.jit the denoiser's float() of a tap
    product raises ConcretizationTypeError; ROADMAP §3.)"""
    cfg = CFG.replace(denoising=DenoisingMode.TEMPORAL, spatial_denoise=True)
    jcfg = _j(cfg)
    eng = Engine(build_cornell_simple(device="cpu"), cfg)
    jscene = jax_cornell()
    jstate = None
    for k in range(4):
        cam, jcam = _orbit(k, 16)
        if jstate is None:
            jstate = jax_init_post_state(jcam, jcfg)
        img = eng.step(cam)
        jimg, jstate = jax_render_frame(jscene, jcam, jcfg, jstate, k)
        ok = np.isclose(img.numpy(), np.asarray(jimg), rtol=IMG_TOL,
                        atol=IMG_TOL).all(-1)
        assert ok.mean() >= MIN_DENOISED_OK, (k, int((~ok).sum()))
    assert isinstance(eng._state, TemporalState)
    assert eng.frame_index == 4
    assert int(eng._state.frame_count) == int(jstate.frame_count)


def test_engine_matches_the_jax_engine():
    """Where the JAX Engine runs (no spatial denoiser): four PROGRESSIVE
    steps under a still camera, image for image."""
    eng = Engine(build_cornell_simple(device="cpu"), CFG)
    jeng = JEngine(jax_cornell(), _j(CFG))
    cam, jcam = _orbit(2, 16)
    for _ in range(4):
        ok = np.isclose(eng.step(cam).numpy(), np.asarray(jeng.step(jcam)),
                        rtol=IMG_TOL, atol=IMG_TOL).all(-1)
        assert ok.mean() >= MIN_PIXELS_OK, int((~ok).sum())
    assert int(eng._state.frame_count) == int(jeng._state.frame_count) == 4


def test_engine_profile_writes_a_trace(tmp_path):
    eng = Engine(build_cornell_simple(device="cpu"), CFG)
    before = {n: s.count for n, s in vars(SPANS).items()}
    with eng.profile(tmp_path / "trace") as prof:
        eng.step(demo_camera(8, 8))
    assert list((tmp_path / "trace").iterdir())
    # The trace holds the program's spans beside the operations, and the
    # summary lists every leaf span that ran.
    ran = {n for n, s in vars(SPANS).items() if s.count > before[n]}
    assert {"engine_step", "render_radiance", "path_trace", "path_shade",
            "path_lanes", "post_passes"} <= ran
    events = json.loads(Path(prof.summary.trace).read_text())["traceEvents"]
    assert ran == {e["name"] for e in events
                   if e.get("cat") == "program_span"}
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert set(prof.summary.spans) == ran
    for n in ran:
        assert prof.summary.spans[n].count == vars(SPANS)[n].count \
            - before[n]
