"""The winner rule of the two-level closest hit (kernels 3 and 6) and of
the flat closest hit (kernels 1 and 11) at exact ties, and the thread-slot
count of the two-level block-cooperative walk.

The CUDA walk (csrc/trace_common.cuh ``walk_two_level``) sweeps a chunk
with a warp per needing ray and reduces the lanes' winners in a shuffle
tree, so it keeps the winner of the one-thread-per-ray sweep only if the
rule is a minimum over a total order: the lowest (t, eidx), a valid hit at
t >= 1e9 never wins. Exact ties test the eidx half of that order. On the
mid-size sphere grid (``build_sphere_grid(n=4, sphere_detail=12)``, 40
padded chunks in 5 superchunks of 8), triangles are copied into other
columns of their own chunk (into a later 32-triangle group, and into an
earlier one), of a chunk of another superchunk, and of a chunk before
theirs; rays aimed at the copied triangles then hit two
triangles at the same t, and the port's plain versions must pick the same
eidx as JAX's interpret-mode kernels: the lower one. The flat walk
(csrc/trace_common.cuh ``walk_flat_coop``) takes the same 40 chunks in
index order, without the superchunk level, against JAX's flat
``_closest_hit_rows``; kernel 11's plain version shows its winner through
a material per triangle whose emission is its eidx.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gdpathtracing_tpu.ops.intersect_pallas as jip

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.ops import fused as fu
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render.types import MISS_T
from gdpathtracing_torch.scene.demo import build_sphere_grid

torch.set_num_threads(1)
# t: as tests/test_torch_superchunk.py (JAX sums the 4-term dots in
# another order; a few ulps of |origin| x |row| as an absolute error).
T_RTOL, T_ATOL = 1e-6, 5e-6
# (source eidx, destination eidx) of each copied triangle: within chunk 3
# (group 0 into group 6), from chunk 3 into chunk 20 (another superchunk),
# from chunk 30 into chunk 9 (a copy before its source, in an earlier
# superchunk), and within chunk 7 from group 7 into group 0 (a copy before
# its source in one chunk).
COPIES = ((3 * 256 + 17, 3 * 256 + 200), (3 * 256 + 40, 20 * 256 + 5),
          (30 * 256 + 100, 9 * 256 + 250), (7 * 256 + 230, 7 * 256 + 12))
N_AIM = 128  # rays aimed at each copied triangle


def _union(boxes, dst, src):
    """Grow box column ``dst`` of the (8, n) array ``boxes`` to hold box
    ``src`` (an (8,) column)."""
    boxes[0:3, dst] = np.minimum(boxes[0:3, dst], src[0:3])
    boxes[3:6, dst] = np.maximum(boxes[3:6, dst], src[3:6])


def dup_scene():
    """The mid grid's kernel operands (numpy) with the COPIES made: the
    triangle rows copied column for column, the destination chunk's and
    superchunk's inflated boxes grown to hold the source chunk's box, and
    the destination group's (kernel 3's group gate) the source group's."""
    tp = ti.prepare_trace_inputs(build_sphere_grid(
        n=4, sphere_detail=12, device="cpu"))
    m = [x.numpy().copy() for x in (tp.mu_pad, tp.mv_pad, tp.mw_pad)]
    cb, sb = tp.chunk_bounds.numpy().copy(), tp.sc_bounds.numpy().copy()
    gb = tp.group_bounds.numpy().copy()
    for src, dst in COPIES:
        for x in m:
            x[:, dst] = x[:, src]
        c_src, c_dst = src // ti.BT, dst // ti.BT
        _union(cb, c_dst, cb[:, c_src])
        _union(sb, c_dst // tp.scc, cb[:, c_src])
        _union(gb, dst // ti.GW, gb[:, src // ti.GW])
    return m, cb, sb, gb, tp.scc


def _aim(m, eidx, n, g):
    """``n`` rays at points inside triangle ``eidx`` (barycentric u, v
    drawn in [0.2, 0.4]), from 1e-2 off its plane on one side."""
    mu, mv, mw = (x[:, eidx].astype(np.float64) for x in m)
    a = np.stack([mu[:3], mv[:3], mw[:3]])
    u, v = g.uniform(0.2, 0.4, (2, n))
    p = np.linalg.solve(a, np.stack([u - mu[3], v - mv[3],
                                     np.full(n, -mw[3])]))
    nrm = mw[:3] / np.linalg.norm(mw[:3])
    o = p + 1e-2 * nrm[:, None]
    d = np.repeat(-nrm[:, None], n, axis=1)
    return o, d


def dup_rays(m):
    """(4, N) o4, d4: N_AIM rays aimed at each copied triangle, N_AIM
    random rays and N_AIM parked ones (origin 1e9), in a seeded random
    order."""
    g = np.random.default_rng(11)
    os_, ds = zip(*(_aim(m, src, N_AIM, g) for src, _ in COPIES))
    o_r = np.stack([g.uniform(-6, 6, N_AIM), g.uniform(-0.5, 7.5, N_AIM),
                    g.uniform(-6, 6, N_AIM)])
    d_r = g.normal(size=(3, N_AIM))
    d_r /= np.linalg.norm(d_r, axis=0, keepdims=True)
    o = np.concatenate([*os_, o_r, np.full((3, N_AIM), 1e9)], axis=1)
    d = np.concatenate([*ds, d_r, np.full((3, N_AIM), 0.5773503)], axis=1)
    perm = g.permutation(o.shape[1])
    n = o.shape[1]
    o4 = np.concatenate([o[:, perm], np.ones((1, n))]).astype(np.float32)
    d4 = np.concatenate([d[:, perm], np.zeros((1, n))]).astype(np.float32)
    aimed = np.concatenate([np.full(N_AIM, i) for i in range(len(COPIES))]
                           + [np.full(2 * N_AIM, -1)])[perm]
    return np.ascontiguousarray(o4), np.ascontiguousarray(d4), aimed


@pytest.fixture(scope="module")
def dup():
    m, cb, sb, gb, scc = dup_scene()
    o4, d4, aimed = dup_rays(m)
    return m, cb, sb, gb, scc, o4, d4, aimed


def _jax_operands(m, cb, sb):
    """JAX's layout of the same operands: m3 interleaves each chunk's mu,
    mv and mw blocks; the boxes are flat per chunk and superchunk."""
    nc = cb.shape[1]
    m3 = np.stack([x.reshape(4, nc, 1, ti.BT) for x in m], axis=2)
    return (jnp.asarray(np.ascontiguousarray(sb.T).reshape(-1)),
            jnp.asarray(np.ascontiguousarray(cb.T).reshape(-1)),
            jnp.asarray(m3.reshape(4, 3 * nc * ti.BT)))


def _port_operands(m, cb, sb, gb=None):
    """Kernel 6's geometry operands; with group boxes ``gb``, kernel 3's."""
    boxes = (sb, cb) if gb is None else (sb, cb, gb)
    return (*map(torch.from_numpy, boxes), *map(torch.from_numpy, m))


def test_aimed_rays_tie(dup):
    """The construction: each aimed ray hits the copy and its source at
    the same t (the plain walk with the copy's column removed again finds
    the source, and the other way round)."""
    m, cb, sb, gb, scc, o4, d4, aimed = dup
    geo = _port_operands(m, cb, sb, gb)
    rays = (torch.from_numpy(o4), torch.from_numpy(d4))
    got = ti.closest_hit_sc_lite(*rays, *geo, scc).numpy()
    for i, (src, dst) in enumerate(COPIES):
        on = aimed == i
        assert (got[0][on] < 0.1).all()  # 1e-2 off the plane
        assert (got[1][on] == min(src, dst)).all()
        for keep in (src, dst):
            drop = max(src, dst) if keep == min(src, dst) else min(src, dst)
            m2 = [x.copy() for x in m]
            for x in m2:
                x[:, drop] = 0.0  # a degenerate column never hits
            one = ti.closest_hit_sc_lite(
                *rays, *_port_operands(m2, cb, sb, gb), scc).numpy()
            assert (one[1][on] == keep).all()
            np.testing.assert_array_equal(one[0][on], got[0][on])


def test_tie_winner_lite_matches_jax(dup):
    m, cb, sb, gb, scc, o4, d4, aimed = dup
    want = np.asarray(jip._closest_hit_sc_lite(
        jnp.asarray(o4), jnp.asarray(d4), *_jax_operands(m, cb, sb),
        scc=scc, interpret=True))
    got = ti.closest_hit_sc_lite(torch.from_numpy(o4), torch.from_numpy(d4),
                                 *_port_operands(m, cb, sb, gb),
                                 scc).numpy()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=T_RTOL, atol=T_ATOL)
    for i, (src, dst) in enumerate(COPIES):
        assert (want[1][aimed == i] == min(src, dst)).all()
    assert (got[0][o4[0] > 1e8] == MISS_T).all()


def test_tie_winner_rows_matches_jax(dup):
    m, cb, sb, _, scc, o4, d4, aimed = dup
    tab = np.random.default_rng(12).uniform(
        size=(ti.TAB_R, m[0].shape[1])).astype(np.float32)
    want = np.asarray(jip._closest_hit_rows_sc(
        jnp.asarray(o4), jnp.asarray(d4), *_jax_operands(m, cb, sb),
        jnp.asarray(tab), scc=scc, interpret=True))
    got = ti.closest_hit_rows_sc(torch.from_numpy(o4), torch.from_numpy(d4),
                                 *_port_operands(m, cb, sb),
                                 torch.from_numpy(tab), scc).numpy()
    np.testing.assert_array_equal(got[44], want[44])
    np.testing.assert_allclose(got[40], want[40], rtol=T_RTOL, atol=T_ATOL)
    for i, (src, dst) in enumerate(COPIES):
        assert (got[44][aimed == i] == min(src, dst)).all()
    # The winner's table row: the lower eidx's, not its copy's.
    hit = got[40] < MISS_T
    np.testing.assert_array_equal(
        got[:ti.TAB_R][:, hit], tab[:, got[44][hit].astype(np.int64)])


@pytest.fixture(scope="module")
def flat_jax(dup):
    """A random winner table and JAX's flat rows kernel in interpret mode on
    the dup operands (its (8, nc) boxes: JAX inflates them once more, which
    only lets more chunks pass the gate and moves no winner)."""
    m, cb, sb, _, _, o4, d4, _ = dup
    tab = np.random.default_rng(13).uniform(
        size=(ti.TAB_R, m[0].shape[1])).astype(np.float32)
    want = np.asarray(jip._closest_hit_rows(
        jnp.asarray(o4), jnp.asarray(d4), jnp.asarray(cb),
        _jax_operands(m, cb, sb)[2], jnp.asarray(tab), interpret=True))
    return tab, want


def test_flat_tie_winner_rows_matches_jax(dup, flat_jax):
    m, cb, _, _, _, o4, d4, aimed = dup
    tab, want = flat_jax
    got = ti.closest_hit_rows(torch.from_numpy(o4), torch.from_numpy(d4),
                              torch.from_numpy(cb), *map(torch.from_numpy, m),
                              torch.from_numpy(tab)).numpy()
    np.testing.assert_array_equal(got[44], want[44])
    np.testing.assert_allclose(got[40], want[40], rtol=T_RTOL, atol=T_ATOL)
    for i, (src, dst) in enumerate(COPIES):
        assert (got[44][aimed == i] == min(src, dst)).all()
    assert (got[40][o4[0] > 1e8] == MISS_T).all()
    hit = got[40] < MISS_T
    np.testing.assert_array_equal(
        got[:ti.TAB_R][:, hit], tab[:, got[44][hit].astype(np.int64)])


def test_flat_tie_winner_fused_matches_jax(dup, flat_jax):
    """One bounce of kernel 11's plain version: triangle e has material e,
    emitting (e, 0, 0) at energy 1, so a hit's radiance is its eidx, and
    its depth its t."""
    m, cb, _, _, _, o4, d4, aimed = dup
    _, want = flat_jax
    e, n = m[0].shape[1], o4.shape[1]
    table = np.zeros((e, ti.TABLE_W), np.float32)
    table[:, 27] = np.arange(e)
    mats = np.zeros((e, ti.MAT_W), np.float32)
    mats[:, 3] = np.arange(e)
    mats[:, 6] = 1.0
    out, segs = fu.fused_paths(
        torch.from_numpy(o4), torch.from_numpy(d4),
        torch.zeros(2, n, dtype=torch.int32), torch.from_numpy(cb),
        *map(torch.from_numpy, m), torch.from_numpy(table),
        torch.from_numpy(mats),
        RenderConfig(traversal=Traversal.FUSED, bounces=1))
    out = out.numpy()
    hit = want[40] < MISS_T
    assert hit.sum() >= len(COPIES) * N_AIM
    np.testing.assert_array_equal(out[3] < MISS_T, hit)
    np.testing.assert_array_equal(out[0][hit], want[44][hit])
    np.testing.assert_allclose(out[3], want[40], rtol=T_RTOL, atol=T_ATOL)
    for i, (src, dst) in enumerate(COPIES):
        assert (out[0][aimed == i] == min(src, dst)).all()
    assert (segs.numpy() == 1).all()


def _gates(*warps):
    """(256,) bool gates of one block: warp w holds ``warps[w]`` needing
    rays (the first lanes), the other warps none."""
    may = torch.zeros(ti.WARPS, 32, dtype=torch.bool)
    for w, k in enumerate(warps):
        may[w, :k] = True
    return may.view(-1)


@pytest.mark.parametrize("warps, slots", [
    ((), 0),                         # no needing ray: the chunk is skipped
    ((1,), 2048),                    # k = 1: one round of the 8 warps x
    #                                  32 lanes x 8 triangles
    ((0,) * 7 + (8,), 2048),         # k = 8
    ((3, 3, 3), 2 * 2048),           # k = 9: two rounds
    ((28,) * 8, 28 * 2048),          # k = 224 = 7/8 of 8 full warps
    ((29,) + (28,) * 7, 8 * 32 * 256),  # k = 225: a thread per ray, the
    #                                  8 warps' 32 lanes x 256 triangles
    ((28,), 4 * 2048),               # k = 28 in one warp: warps
    ((0, 29), 32 * 256),             # k = 29 in one warp: its threads
    ((32,) * 8, 8 * 32 * 256),
])
def test_two_level_slots(warps, slots):
    got = ti.two_level_slots(_gates(*warps))
    assert got.shape == (1,)
    assert float(got[0]) == slots


def test_two_level_slots_per_block():
    """Blocks are counted apart, in ray order."""
    may = torch.cat([_gates(5), _gates(), _gates(32, 32)])
    np.testing.assert_array_equal(ti.two_level_slots(may).numpy(),
                                  [2048, 0, 2 * 32 * 256])
