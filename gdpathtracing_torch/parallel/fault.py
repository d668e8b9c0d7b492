"""Failure detection and recovery for multi-device rendering — port of
gdpathtracing_tpu/parallel/fault.py.

A frame is stateless per (pixel, frame index): the RNG is keyed by pixel and
frame (core/rng.prng_seed), never by device or rank, so any tile can be
re-rendered bit-identically wherever a ray's answer does not depend on the
batch it is traced in. The kernels' winners (PALLAS, BVH) do not; the
tests hold healed == clean on the CPU for PALLAS and UNIT, and on the card
it is measured for PALLAS only (UNIT's cuBLAS product is not measured).
Recovery is re-dispatch:

1. **Detect**: a per-tile health check on the returned AOVs. A dead or
   faulting device shows as NaN/Inf radiance, a negative depth, or a tile
   with no traced segment (every camera ray traces at least one).
2. **Recover**: re-render exactly the bad tiles (flat pixel-id batches,
   through the sharded renderer's per-pixel program on the scene's device)
   and write them back into the frame on the frame's own device.

``render_with_retry`` wraps any frame function; ``inject_tile_fault``
corrupts a tile the way a failing device would (the tests' hook).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.renderer import FrameAOVs
from gdpathtracing_torch.scene.scene import Scene


def tile_health(aovs: FrameAOVs, tile: int = 64) -> np.ndarray:
    """(TH, TW) bool: True where the tile looks healthy. A tile is bad if
    any radiance, depth or normal entry is non-finite, any depth is
    negative, or the whole tile reports zero traced segments. Vectorised:
    the frame is padded to whole tiles with benign values and reduced."""
    h, w = aovs.depth.shape
    th, tw = -(-h // tile), -(-w // tile)
    ph, pw = th * tile - h, tw * tile - w

    def tiles(x, fill):
        """(h, w[, c]) → (th, tile, tw, tile·c) with benign padding."""
        pad = ((0, ph), (0, pw)) + ((0, 0),) * (x.ndim - 2)
        x = np.pad(x.detach().cpu().numpy(), pad, constant_values=fill)
        return x.reshape(th, tile, tw, -1)

    rad = tiles(aovs.radiance, 0.0)
    nrm = tiles(aovs.normal, 0.0)
    dep = tiles(aovs.depth, 0.0)
    segs = tiles(aovs.segments, 0)
    bad = ~np.isfinite(rad).all(axis=(1, 3))
    bad |= ~np.isfinite(nrm).all(axis=(1, 3))
    bad |= (~np.isfinite(dep) | (dep < 0.0)).any(axis=(1, 3))
    # Padding adds 0 segments; every tile holds at least one real pixel.
    bad |= segs.sum(axis=(1, 3), dtype=np.int64) <= 0
    return ~bad


def _tile_pixels(ty: int, tx: int, tile: int, h: int, w: int):
    """(rows, cols, flat pixel ids) of tile (ty, tx)."""
    ys = slice(ty * tile, min((ty + 1) * tile, h))
    xs = slice(tx * tile, min((tx + 1) * tile, w))
    yy, xx = np.mgrid[ys, xs]
    return ys, xs, torch.from_numpy((yy * w + xx).ravel())


def redundancy_probe(scene: Scene, camera: Camera, config: RenderConfig,
                     frame_index, aovs: FrameAOVs, k: int = 2,
                     tile: int = 64, seed: int = 0,
                     atol: float = 1e-4, frac_bad: float = 0.01
                     ) -> list[tuple[int, int]]:
    """Silent-corruption detector: re-trace ``k`` randomly chosen tiles
    through the per-pixel program and compare. ``tile_health`` catches only
    loud failures; a finite-but-wrong tile (bit flips, a miscompiled kernel
    on one device) passes it. The comparison is allclose per pixel with a
    gate on the share of mismatching pixels, not bit-equality: the default
    regen frame keeps each path's transport but is another program than the
    per-pixel one. Returns the (ty, tx) tiles whose mismatch exceeds
    ``frac_bad``."""
    h, w = aovs.depth.shape
    th, tw = -(-h // tile), -(-w // tile)
    rng = np.random.default_rng(seed)
    n_tiles = th * tw
    picks = rng.choice(n_tiles, size=min(k, n_tiles), replace=False)
    bad: list[tuple[int, int]] = []
    for p in picks:
        ty, tx = int(p) // tw, int(p) % tw
        ys, xs, pids = _tile_pixels(ty, tx, tile, h, w)
        rgb = _render_pixel_batch(scene, camera, config, frame_index,
                                  pids)[0]
        got = aovs.radiance[ys, xs].detach().cpu().numpy()
        ref = rgb.detach().cpu().numpy().reshape(got.shape)
        mism = ~np.isclose(got, ref, atol=atol, rtol=1e-3)
        if not np.isfinite(got).all() or \
                mism.any(axis=-1).mean() > frac_bad:
            bad.append((ty, tx))
    return bad


def _render_pixel_batch(scene: Scene, camera: Camera, config: RenderConfig,
                        frame_index, pids: torch.Tensor):
    """Re-render a flat batch of pixel ids (the recovery path) through the
    sharded renderer's per-pixel program, on the scene's device."""
    from gdpathtracing_torch.parallel.sharding import _trace_pixels
    return _trace_pixels(scene, camera, pids, frame_index, config)


def render_with_retry(scene: Scene, camera: Camera, config: RenderConfig,
                      frame_index,
                      render_fn: Callable[..., FrameAOVs],
                      max_retries: int = 2,
                      tile: int = 64,
                      on_retry: Callable[[int, int], None] | None = None,
                      probe_tiles: int = 0
                      ) -> tuple[FrameAOVs, int]:
    """Render a frame and heal unhealthy tiles by re-dispatching exactly
    those pixels. Returns (aovs, tiles_recovered).

    ``render_fn(scene, camera, config, frame_index) -> FrameAOVs`` is the
    primary (possibly sharded) frame path; recovery re-traces the bad tiles
    with the per-pixel program, which gives the standard loop's pixels bit
    for bit, and writes them into the frame on its own device.
    ``probe_tiles > 0`` also runs the redundancy probe each attempt: probed
    tiles whose radiance disagrees with an independent re-trace are healed
    like loud failures."""
    aovs = render_fn(scene, camera, config, frame_index)
    h, w = camera.height, camera.width
    recovered = 0
    for attempt in range(max_retries):
        ok = tile_health(aovs, tile)
        if probe_tiles > 0:
            for ty, tx in redundancy_probe(
                    scene, camera, config, frame_index, aovs,
                    k=probe_tiles, tile=tile,
                    seed=int(np.uint32(frame_index)) + attempt):
                ok[ty, tx] = False
        if ok.all():
            break
        bad = np.argwhere(~ok)
        if on_retry is not None:
            on_retry(attempt, len(bad))
        fields = [x.detach().clone() for x in aovs]
        for ty, tx in bad:
            ys, xs, pids = _tile_pixels(int(ty), int(tx), tile, h, w)
            healed = _render_pixel_batch(scene, camera, config, frame_index,
                                         pids)
            for dst, src in zip(fields, healed):  # the FrameAOVs order
                dst[ys, xs] = src.detach().to(dst.device).reshape(
                    dst[ys, xs].shape)
            recovered += 1
        aovs = FrameAOVs(*fields)
    return aovs, recovered


def inject_tile_fault(aovs: FrameAOVs, ty: int, tx: int,
                      tile: int = 64, kind: str = "nan") -> FrameAOVs:
    """Fault injection for tests: corrupt one tile the way a failing device
    does: NaN radiance ("nan"), a silently dropped tile with zero segments
    ("drop"), or finite-but-wrong radiance ("silent", which passes
    tile_health; only the redundancy probe catches it)."""
    rad = aovs.radiance.detach().clone()
    segs = aovs.segments.detach().clone()
    h, w = aovs.depth.shape
    ys = slice(ty * tile, min((ty + 1) * tile, h))
    xs = slice(tx * tile, min((tx + 1) * tile, w))
    if kind == "nan":
        rad[ys, xs] = torch.nan
    elif kind == "drop":
        rad[ys, xs] = 0.0
        segs[ys, xs] = 0
    elif kind == "silent":
        rad[ys, xs] = rad[ys, xs] * 0.75 + 0.125
    else:
        raise ValueError(kind)
    return aovs._replace(radiance=rad, segments=segs)
