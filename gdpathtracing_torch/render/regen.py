"""Path-regeneration frame loop: a persistent, always-full wavefront.

Port of gdpathtracing_tpu/render/regen.py, the default frame loop of every
primal ``Traversal.PALLAS`` render, and the loop of ``Traversal.BRUTE`` and
``Traversal.UNIT`` with ``regen=True``. Instead of letting the lanes of dead
paths idle until the last bounce, every iteration refills them with the
next unstarted paths of the frame's pool: a fresh camera ray is pure
arithmetic of its path id (pixel = id % n_pix, sample = id // n_pix, the
PCG2D seed of (pixel, frame·spp + sample)), so each path draws exactly the
random numbers, and runs exactly the per-segment arithmetic, of the
standard loop (render/integrator.py), and the frame equals that loop's.

One iteration traces one segment of every live lane (kernel 1, or on a
scene of more than 16 chunks a superchunk kernel; with NEE also one shadow
query per lane, kernel 2; BRUTE and UNIT trace both with their plain
oracles), shades it and samples the next direction (with the dielectric
lobe and Russian roulette of the standard loop). With ``regen_march=True`` on a superchunk scene that kernel 3
takes, an iteration is one round of the frontier march instead (kernel 7,
:func:`ops.intersect.march_sweep`): each 256-lane block sweeps the <= QL
superchunks its lanes want next, from each lane's carried best, and only
the lanes whose segment resolved shade; the others keep their state, RNG
stream position included, for the next round. Then the lanes are
permuted: live lanes sorted by the Morton cell of their origin and the
octant of their direction on PALLAS or where ``sort_rays=True`` (blocks
of similar rays sweep fewer chunks; the march sorts by the next two
superchunks instead), else survivors first in lane order, then this
iteration's
dead, then the lanes that were dead before. Finished paths are retired by
one contiguous append to a column-major log (or,
``regen_retire="scatter"``, written to their pixel at once), and the dead
tail is refilled from the pool. When the pool
is empty and the live lanes fit, the sorted live prefix moves on at a
smaller wavefront (the drain), and the log is indexed by path id at the
end.

``lax.while_loop`` becomes a host loop: each iteration reads the two counts
the log append and the loop condition need with one small ``.tolist()``.
Lane state is carried as an (17, nw) float32 and a (6, nw) int64 stack, so
the permute is two gathers; the PCG2D seeds ride the int64 stack as they
are, the march adds its cursor and running best (2 rows to each), and
fused NEE the shadow queries just posted (10 float rows, 1 int64 row).

With ``regen_sort_key="chunk"`` the sorted lanes (without the march, whose
key takes precedence) are keyed on the first chunk each ray enters, or on a
scene of more than 64 chunks the first superchunk (:func:`first_chunk_key`),
in place of the Morton cell of their origin.

With ``regen_fuse_nee=True`` on a flat PALLAS scene with NEE, an
iteration's shadow queries ride the next iteration's closest-hit launch
(kernel 4, :func:`ops.intersect.trace_occlude_pallas`: phase A this
iteration's closest hit, phase B the queries posted the iteration before).
Each pending query carries the id of the path that posted it (lanes are
permuted and refilled in between): where the lane still holds that path,
the resolved direct term adds to its radiance; where the path retired right
after posting, its row was retired without the term (logged or scattered
as unfused NEE retires it) and the term is added to that row in place. The
loop runs until the last pending queries are resolved, with no drain
stage. On a superchunk scene regen renders unfused NEE, as the
reference does. The TPU package's timing hooks (``_DEBUG``) are not ported.
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3, where as vwhere
from gdpathtracing_torch.ops.intersect import (BIG_E, BN, SCC, TracePrep,
                                               lite_epilogue,
                                               march_block_queue,
                                               march_next_candidates,
                                               march_supported, march_sweep,
                                               occluded_pallas,
                                               prepare_trace_inputs,
                                               trace_occlude_pallas)
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.integrator import (check_supported,
                                                   continue_path,
                                                   get_trace_fn,
                                                   hit_visibility,
                                                   mis_emission,
                                                   morton_frame,
                                                   morton_octant_key,
                                                   sample_direct)
from gdpathtracing_torch.render.lights import build_light_table
from gdpathtracing_torch.render.shading import get_shading_data
from gdpathtracing_torch.render.sky import sample_sky
from gdpathtracing_torch.render.types import MISS_T, Ray
from gdpathtracing_torch.scene.scene import Scene

# Rows of the float lane stack ...
_O, _D, _TP, _RAD = 0, 3, 6, 9          # Vec3 rows start here
_PREV_PDF, _DEPTH, _NRM = 12, 13, 14
_LOG_F = [9, 10, 11, 13, 14, 15, 16]    # radiance, depth, normal
_MT, _BT = 17, 18                       # the march's (m_t, b_t)
# ... and of the int64 lane stack.
_SEED, _PID, _BOUNCE, _STEPS, _SEGS = 0, 2, 3, 4, 5
_MSC, _BE = 6, 7                        # the march's (m_sc, b_e)
_NF, _NI = 17, 6                        # lane rows of both (no march)
# ... and of the fused NEE's posted queries, carried after the lane rows
# through the permutation: float rows [shadow o3 d3 tmax direct3], int64
# row [query posted].
_P_O, _P_D, _P_TMAX, _P_DIRECT = 0, 3, 6, 7
_STEPS_MAX = (1 << 19) - 1  # the log path clamps steps (as the reference)
# Up to this many chunks the first-chunk key tests chunk boxes, above it
# superchunk boxes of SCC chunks (the reference's rule).
KEY_MAX_CHUNKS = 64
MAX_IT = 96  # slots of the per-iteration stats; later iterations share the
#              last one (as the reference)


def regen_supported(scene: Scene, config: RenderConfig) -> bool:
    """The reference's gate for the regeneration frame loop."""
    return (config.traversal in (Traversal.PALLAS, Traversal.UNIT,
                                 Traversal.BRUTE)
            and not config.differentiable
            and config.soft_shadows == 0.0
            and config.soft_primary == 0.0)


def regen_auto(scene: Scene, config: RenderConfig) -> bool:
    """``config.regen=None`` policy: every supported PALLAS render."""
    return (config.traversal == Traversal.PALLAS
            and regen_supported(scene, config))


def use_march(config: RenderConfig, prep: TracePrep | None) -> bool:
    """Whether regen marches (the reference's rule): ``regen_march=True``
    on a PALLAS render of a scene :func:`ops.intersect.march_supported`
    takes (``prep`` is PALLAS's, None for the oracles). Elsewhere the flag
    is ignored and the frame is the one without it."""
    return config.regen_march is True and prep is not None \
        and march_supported(prep)


def sorts_lanes(config: RenderConfig) -> bool:
    """Whether regen sorts its lanes by a spatial key (the reference's
    rule): ``sort_rays``, by default on PALLAS only, and only where the
    lanes are permuted at all (``compact_rays`` not False)."""
    sort = config.sort_rays
    if sort is None:
        sort = config.traversal == Traversal.PALLAS
    return bool(sort) and config.compact_rays is not False


def fuses_nee(scene: Scene, config: RenderConfig,
              prep: TracePrep | None) -> bool:
    """Whether regen fuses its shadow queries into the next closest-hit
    launch (the reference's rule): ``regen_fuse_nee`` with NEE on a flat
    PALLAS scene (``prep`` is PALLAS's, None for the oracles); a superchunk
    scene renders unfused NEE."""
    return bool(config.nee and scene.n_lights > 0 and config.regen_fuse_nee
                and prep is not None and not prep.superchunks)


def _drain_sizes(config: RenderConfig, nw: int, n_paths: int,
                 compact: bool) -> list[int]:
    """Wavefronts of the drain stages (the reference's two-stage rule)."""
    if not compact or config.regen_drain is False:
        return []
    dn = config.regen_drain_wavefront
    if dn is None:
        dn = max(BN, (nw // 4) // BN * BN)
    if not (dn < nw and (config.regen_drain is True
                         or n_paths >= 2 * nw)):
        return []
    dn2 = max(BN, (dn // 4) // BN * BN)
    return [dn, dn2] if dn2 < dn else [dn]


def march_lane_key(d: Vec3, s0, s1, nsc: int) -> torch.Tensor:
    """The march's lane key: (next superchunk ``s0``, the one after it
    ``s1``, each clamped to [0, ``nsc``]) * 8 + the octant of direction
    ``d``, so the lanes of a block want the same sweeps. int64."""
    octant = (d.x > 0.0).to(torch.int64) * 4 \
        + (d.y > 0.0).to(torch.int64) * 2 + (d.z > 0.0).to(torch.int64)
    return (torch.clamp(s0, 0, nsc) * (nsc + 1)
            + torch.clamp(s1, 0, nsc)) * 8 + octant


def chunk_key_bounds(chunk_bounds: torch.Tensor) -> torch.Tensor:
    """The boxes :func:`first_chunk_key` tests: the scene's (8, nc) chunk
    boxes (``Scene.isect_chunk_bounds``) up to ``KEY_MAX_CHUNKS`` chunks;
    above that one box per superchunk of ``SCC`` chunks (the superchunk
    kernels' unit of work, and nc slab tests a lane would cost too much),
    the pad chunks at 1e30 left out of each box's maxima."""
    nc = chunk_bounds.shape[1]
    if nc <= KEY_MAX_CHUNKS:
        return chunk_bounds
    cbp = torch.nn.functional.pad(chunk_bounds, (0, (-nc) % SCC), value=1e30)
    nsc = cbp.shape[1] // SCC
    lo = cbp[0:3].reshape(3, nsc, SCC).amin(dim=2)
    hi = cbp[3:6].reshape(3, nsc, SCC)
    hi = torch.where(hi > 1e29, -1e30, hi).amax(dim=2)
    return torch.cat([lo, hi, cbp.new_zeros((2, nsc))])


def first_chunk_key(o: Vec3, d: Vec3, alive, fresh,
                    bounds: torch.Tensor) -> torch.Tensor:
    """The first-chunk lane key (``regen_sort_key="chunk"``): for live
    lanes, the index of the box of ``bounds`` (:func:`chunk_key_bounds`)
    the ray enters first (the least entry max(slab tmin, 0) over the boxes
    its slab test passes, the lowest index at a tie; the box count where it
    passes none) * 8 + the octant of its direction, so a block's rays want
    the same sweeps; then this iteration's dead (``fresh``, 1 << 14), then
    the lanes dead before (1 << 15). int64."""
    def rcp(x):
        return (1.0 / torch.where(x.abs() < 1e-30, 1e-30, x))[:, None]

    def slab(k, ok, rk):
        return (bounds[k][None, :] - ok[:, None]) * rk, \
            (bounds[k + 3][None, :] - ok[:, None]) * rk

    (tx1, tx2), (ty1, ty2), (tz1, tz2) = (slab(0, o.x, rcp(d.x)),
                                          slab(1, o.y, rcp(d.y)),
                                          slab(2, o.z, rcp(d.z)))
    tmin = torch.maximum(torch.maximum(torch.minimum(tx1, tx2),
                                       torch.minimum(ty1, ty2)),
                         torch.minimum(tz1, tz2))
    tmax = torch.minimum(torch.minimum(torch.maximum(tx1, tx2),
                                       torch.maximum(ty1, ty2)),
                         torch.maximum(tz1, tz2))
    entry = torch.clamp(tmin, min=0.0)
    # The reference's scan keeps a box whose entry is strictly below the
    # best so far: the first of the least finite entries.
    cand = torch.where((tmax >= tmin) & (tmax > 0.0) & (entry < torch.inf),
                       entry, torch.inf)
    nc = bounds.shape[1]
    best_c = torch.where(cand.amin(dim=1) < torch.inf, cand.argmin(dim=1),
                         nc)
    octant = (d.x > 0.0).to(torch.int64) * 4 \
        + (d.y > 0.0).to(torch.int64) * 2 + (d.z > 0.0).to(torch.int64)
    return torch.where(alive, best_c * 8 + octant,
                       torch.where(fresh, 1 << 14, 1 << 15))


def render_radiance_regen(scene: Scene, camera: Camera,
                          config: RenderConfig, frame_index: int = 0,
                          return_stats: bool = False):
    """Full-frame trace with path regeneration on ``scene.device``. Returns
    FrameAOVs (the contract of renderer.render_radiance); with
    ``return_stats``, (FrameAOVs, {"iters", "lane_slots", "it_alive",
    "it_sweeps_a", "it_sweeps_b", "n_blocks"}): iterations over all
    stages, lanes traced summed over them, per iteration (``MAX_IT`` slots,
    iterations past the last slot overwriting it) the live lanes (int32)
    and the sums over 256-lane blocks of the winner rows' counters 46 and
    47 (f32: the chunks, or superchunks and chunks, each block swept in
    the traversal's visit order; 0 where the traversal returns no rows:
    the lite kernel, the march), and 256-ray blocks of the first stage.
    The iterations are also added to
    ``render_radiance_regen.iterations``."""
    from gdpathtracing_torch.render.renderer import FrameAOVs

    pallas = config.traversal == Traversal.PALLAS
    prep = prepare_trace_inputs(scene) if pallas else None
    check_supported(scene, config)
    march = use_march(config, prep)
    fuse = fuses_nee(scene, config, prep)
    if march:
        QL, MK = int(config.regen_march_ql), int(config.regen_march_k)
        nsc = prep.sc_bounds.shape[1]
    dev = scene.device
    camera = camera.to(dev)
    w, h = camera.width, camera.height
    n_pix = w * h
    n_paths = n_pix * config.spp
    nw = min(config.regen_wavefront, -(-n_paths // BN) * BN)
    frame_index = int(frame_index)
    use_nee = config.nee and scene.n_lights > 0
    compact = config.compact_rays is not False
    use_log = config.regen_retire == "log" and compact
    sort_lanes = sorts_lanes(config)
    if config.regen_sort_key == "chunk" and sort_lanes and not march:
        key_bounds = chunk_key_bounds(scene.isect_chunk_bounds.detach())
    else:
        key_bounds = None
    table = None if not use_nee else prep.lights if pallas \
        else build_light_table(scene)
    trace = get_trace_fn(config)
    cell_lo, cell_span = morton_frame(scene)

    def spawn(path_id):
        """Camera ray and RNG stream of path ``path_id`` (pixel-major
        within each sample), as the standard renderer spawns it."""
        pix = path_id % n_pix
        sample = torch.div(path_id, n_pix, rounding_mode="floor")
        seed = rng.prng_seed(pix % w, torch.div(pix, w, rounding_mode="floor"),
                             frame_index * config.spp + sample)
        return camera.generate_rays(pix, seed, config)

    def lane_sort_key(o: Vec3, d: Vec3, alive, fresh):
        """Morton(origin cell, 8^3) * 8 + octant(direction) for live
        lanes (or the first-chunk key); then this iteration's dead (the log
        appends them as one block), then the lanes that were dead
        before."""
        if key_bounds is not None:
            return first_chunk_key(o, d, alive, fresh, key_bounds)
        return torch.where(alive,
                           morton_octant_key(o, d, cell_lo, cell_span),
                           torch.where(fresh, 1 << 14, 1 << 15))

    def march_candidates(fs, ints, active):
        """The next MK superchunks of every lane after its march cursor,
        and the block queues they give."""
        es, ss = march_next_candidates(prep, Vec3(*fs[_O:_O + 3]),
                                       Vec3(*fs[_D:_D + 3]), active,
                                       fs[_MT], ints[_MSC], fs[_BT], k=MK)
        return es, ss, march_block_queue(ss, nsc, QL)[0]

    def march_sort_key(d: Vec3, alive, fresh, rem_s, ss, advs):
        """The march's two-level key (:func:`march_lane_key`) for live
        lanes; then this iteration's dead, then the lanes that were dead
        before. A freshly resolved lane keeps its stale candidates, a
        locality proxy until the next scan."""
        rem2 = ss[1] if MK > 1 else ss[0]
        for i in range(MK - 2):
            rem2 = torch.where(advs[i], ss[i + 2], rem2)
        if MK > 1:
            rem2 = torch.where(advs[MK - 2], rem_s, rem2)
        key = march_lane_key(d, rem_s, rem2, nsc)
        return torch.where(alive, key,
                           torch.where(fresh, 1 << 22, 1 << 23))

    # Lane state: float rows [o3 d3 throughput3 radiance3 prev_pdf depth
    # normal3 (m_t b_t)], int64 rows [seed2 pid bounce steps segs (m_sc
    # b_e)]; the march's cursor (m_t, m_sc) and running best (b_t, b_e)
    # start at (-inf, -1) and (MISS_T, BIG_E).
    lane = torch.arange(nw, device=dev)
    ray0, seed0 = spawn(lane)
    zero = torch.zeros(nw, dtype=torch.float32, device=dev)
    fs = torch.stack([*ray0.o, *ray0.d, zero + 1.0, zero + 1.0, zero + 1.0,
                      zero, zero, zero, zero - 1.0, zero + camera.far,
                      zero, zero, zero]
                     + ([zero - torch.inf, zero + MISS_T] if march else []))
    izero = torch.zeros(nw, dtype=torch.int64, device=dev)
    ints = torch.stack([seed0[0], seed0[1], lane, izero, izero, izero]
                       + ([izero - 1, izero + BIG_E] if march else []))
    # What a fresh path starts with besides its ray and seed.
    spawn_f = fs[_TP:]
    spawn_i = ints[_BOUNCE:]
    active = lane < n_paths
    next_path = nact = min(nw, n_paths)
    if march:
        es, ss, queue = march_candidates(fs, ints, active)

    if use_log:
        log_f = torch.zeros((len(_LOG_F), n_paths + nw), dtype=torch.float32,
                            device=dev)
        log_i = torch.zeros((3, n_paths + nw), dtype=torch.int64, device=dev)
        retired = 0
    else:  # one extra column takes the writes of lanes that retire nothing
        out_f = torch.zeros((len(_LOG_F), n_paths + 1), dtype=torch.float32,
                            device=dev)
        out_i = torch.zeros((2, n_paths + 1), dtype=torch.int64, device=dev)

    if fuse:  # no query is pending at the start
        pend_f = torch.zeros((_P_DIRECT + 3, nw), dtype=torch.float32,
                             device=dev)
        p_sh = torch.zeros(nw, dtype=torch.bool, device=dev)
        p_pid = torch.zeros(nw, dtype=torch.int64, device=dev)
    n_pend = n_last = dstart = last_log = 0

    stages = [nw] + _drain_sizes(config, nw, n_paths, compact and not fuse)
    iters = lane_slots = 0
    if return_stats:
        it_alive = torch.zeros(MAX_IT, dtype=torch.int32, device=dev)
        it_sweeps = torch.zeros((2, MAX_IT), dtype=torch.float32, device=dev)
    for k, size in enumerate(stages):
        # A drain stage takes over the live prefix of the sorted lanes.
        fs, ints, active = fs[:, :size], ints[:, :size], active[:size]
        if march and k > 0:  # ... and re-queues from its candidates
            es, ss = [x[:size] for x in es], [x[:size] for x in ss]
            queue = march_block_queue(ss, nsc, QL)[0]
        threshold = stages[k + 1] if k + 1 < len(stages) else 0
        lane = torch.arange(size, device=dev)
        while next_path < n_paths or nact > threshold or n_pend:
            ray_o = Vec3(*fs[_O:_O + 3])
            ray_d = Vec3(*fs[_D:_D + 3])
            tp = Vec3(*fs[_TP:_TP + 3])
            rad = Vec3(*fs[_RAD:_RAD + 3])
            prev_pdf, depth1 = fs[_PREV_PDF], fs[_DEPTH]
            normal1 = Vec3(*fs[_NRM:_NRM + 3])
            seed = (ints[_SEED], ints[_SEED + 1])
            pid, bounce = ints[_PID], ints[_BOUNCE]
            steps, segs = ints[_STEPS], ints[_SEGS]

            # ---- one path segment: the standard loop's body ----
            r = Ray(ray_o, ray_d)
            if march:
                # One march round: sweep each block's queued superchunks
                # into the carried best, advance each lane's cursor
                # through every candidate its block's queue swept, and
                # resolve the segment where no candidate left can beat the
                # running best (rem_e > b_t: an exact-entry tie still
                # sweeps, which keeps the lexicographic winner).
                m_t, b_t = fs[_MT], fs[_BT]
                m_sc, b_e = ints[_MSC], ints[_BE]
                b_t, b_e, tsteps = march_sweep(prep, r, active, b_t, b_e,
                                               queue)
                qr = queue.view(-1, 1, QL).expand(-1, BN, QL).reshape(
                    size, QL)
                advs, prev = [], active
                for i in range(MK):
                    prev = prev & (ss[i] < nsc) \
                        & (qr == ss[i][:, None]).any(dim=1)
                    advs.append(prev)
                for i in range(MK):
                    m_t = torch.where(advs[i], es[i], m_t)
                    m_sc = torch.where(advs[i], ss[i], m_sc)
                rem_e, rem_s = es[0], ss[0]
                for i in range(MK - 1):
                    rem_e = torch.where(advs[i], es[i + 1], rem_e)
                    rem_s = torch.where(advs[i], ss[i + 1], rem_s)
                # A lane that advanced through all MK cannot prove it is
                # done: the next scan finds its frontier.
                shade = active & ~advs[MK - 1] \
                    & ((rem_s >= nsc) | (rem_e > b_t))
                hit = lite_epilogue(scene, prep, r, shade, b_t,
                                    b_e.to(torch.int32))
            elif fuse:
                # Phase A: this iteration's closest hit; phase B: the
                # shadow queries posted the iteration before.
                hit, p_occ = trace_occlude_pallas(
                    scene, r, active, Ray(Vec3(*pend_f[_P_O:_P_O + 3]),
                                          Vec3(*pend_f[_P_D:_P_D + 3])),
                    pend_f[_P_TMAX], p_sh, prep)
                shade, tsteps = active, hit.steps
                # Fold each resolved direct term into its path: the lane if
                # it still holds the posting path (path ids are never
                # reused), else the row the path retired with the iteration
                # before (late).
                contrib = Vec3(*pend_f[_P_DIRECT:_P_DIRECT + 3]) \
                    * (~p_occ).to(torch.float32)
                own = p_sh & (p_pid == pid) & active
                rad = vwhere(own, rad + contrib, rad)
                late = p_sh & ~own
                contrib = torch.stack([*contrib])
                if use_log:  # the block appended last, whose lanes follow
                    #          the survivors of the last permutation
                    rows = slice(dstart, dstart + n_last)
                    v = log_f[0:3, last_log:last_log + n_last]
                    v.copy_(torch.where(late[rows], v + contrib[:, rows], v))
                else:  # the lanes that retire nothing write the extra column
                    slot = torch.where(late, p_pid, n_paths)
                    out_f[0:3, slot] = out_f[0:3, slot] + contrib
            else:
                hit = trace(scene, r, active, prep)
                shade, tsteps = active, hit.steps
            if return_stats:
                it = min(iters, MAX_IT - 1)
                it_alive[it] = active.sum()
                if hit.rows is not None:
                    it_sweeps[:, it] = hit.rows[46:48, ::BN].sum(dim=1)
            # `shade`: the lanes whose segment resolved this iteration
            # (all active lanes without the march). Only they shade, draw
            # random numbers and count a segment.
            steps = steps + torch.where(active, tsteps, 0)
            seed_before = seed
            is_hit = hit.hit & shade
            segs = segs + shade.to(torch.int64)

            s = get_shading_data(scene, hit, r, fast=config.traversal
                                 != Traversal.BRUTE)
            sky = sample_sky(ray_d, config, scene)
            emission = vwhere(is_hit, s.emission, sky)
            if use_nee:
                emission = mis_emission(scene, table, hit, r.d, emission,
                                        is_hit, prev_pdf)
            rad = vwhere(shade, rad + tp * emission, rad)

            if use_nee:
                # PALLAS: one any-hit launch (kernel 2); the oracles: a
                # closest hit of their own, visible where nothing is hit
                # before the light.
                dl, seed = sample_direct(
                    s, tp, is_hit, seed, table, config, None if pallas
                    else hit_visibility(trace, scene, prep))
                direct = dl.direct
                if pallas and not fuse:
                    occ = occluded_pallas(scene, dl.shadow, dl.tmax,
                                          dl.active, prep)
                    direct = direct * (~occ).to(torch.float32)
                if scene.has_transmission:
                    direct = direct * (1.0 - s.transmission)
                segs = segs + dl.active.to(torch.int64)
                if not fuse:  # fused: resolves in the next launch
                    rad = vwhere(active, rad + direct, rad)

            first = (bounce == 0) & is_hit
            depth1 = torch.where(first, (s.position - ray_o).length(),
                                 depth1)
            normal1 = vwhere(first, s.normal, normal1)

            new_o, new_dir, new_tp, survive, pdf, seed = continue_path(
                s, hit, r, tp, is_hit, seed, config, scene.has_transmission,
                bounce)
            if march:
                # A pending lane keeps its stream position.
                seed = (torch.where(shade, seed[0], seed_before[0]),
                        torch.where(shade, seed[1], seed_before[1]))
            ray_o = vwhere(survive, new_o, ray_o)
            ray_d = vwhere(survive, new_dir, ray_d)
            tp = vwhere(survive, new_tp, tp)
            if march:
                prev_pdf = torch.where(survive, pdf,
                                       torch.where(shade, -1.0, prev_pdf))
                bounce = bounce + shade.to(torch.int64)
                alive = (active & ~shade) \
                    | (survive & (bounce < config.bounces))
                # A resolved lane starts a new march (or retires).
                b_t = torch.where(shade, MISS_T, b_t)
                b_e = torch.where(shade, BIG_E, b_e)
                m_t = torch.where(shade, -torch.inf, m_t)
                m_sc = torch.where(shade, -1, m_sc)
            else:
                prev_pdf = torch.where(survive, pdf, -1.0)
                bounce = bounce + active.to(torch.int64)
                alive = active & survive & (bounce < config.bounces)
            dead_now = active & ~alive
            counts = [alive.sum(), dead_now.sum()]
            if fuse:
                counts.append(dl.active.sum())
            n_alive, n_fresh, *n_posted = torch.stack(counts).tolist()

            # Fused: the queries just posted ride the permutation after
            # the lane rows; each resolves in the next launch.
            fs = torch.stack([*ray_o, *ray_d, *tp, *rad, prev_pdf, depth1,
                              *normal1] + ([m_t, b_t] if march else [])
                             + ([*dl.shadow.o, *dl.shadow.d, dl.tmax,
                                 *direct] if fuse else []))
            ints = torch.stack([seed[0], seed[1], pid, bounce, steps, segs]
                               + ([m_sc, b_e] if march else [])
                               + ([dl.active.to(torch.int64)] if fuse
                                  else []))
            if not use_log:  # retire finished paths to their slot at once
                slot = torch.where(dead_now, pid, n_paths)
                out_f[:, slot] = fs[_LOG_F]
                out_i[:, slot] = ints[_STEPS:_SEGS + 1]

            # ---- permute: live | freshly dead | dead before ----
            if compact:
                if sort_lanes and march:
                    perm = torch.argsort(march_sort_key(
                        ray_d, alive, dead_now, rem_s, ss, advs),
                        stable=True)
                elif sort_lanes:
                    perm = torch.argsort(
                        lane_sort_key(ray_o, ray_d, alive, dead_now),
                        stable=True)
                else:
                    stale = ~alive & ~dead_now
                    dest = torch.where(
                        alive, torch.cumsum(alive, 0),
                        torch.where(dead_now,
                                    n_alive + torch.cumsum(dead_now, 0),
                                    n_alive + n_fresh
                                    + torch.cumsum(stale, 0))) - 1
                    perm = torch.empty_like(lane)
                    perm[dest] = lane
                fs, ints = fs[:, perm], ints[:, perm]
                alive = lane < n_alive
            if fuse:  # the queries, apart from the lanes (views: the
                #       refill below writes new stacks)
                pend_f, p_sh, p_pid = fs[_NF:], ints[_NI].bool(), ints[_PID]
                fs, ints = fs[:_NF], ints[:_NI]
                n_pend, n_last, dstart = n_posted[0], n_fresh, n_alive
            if use_log:  # the freshly dead block, appended in one copy
                last_log = retired
                fresh = slice(n_alive, n_alive + n_fresh)
                log_f[:, retired:retired + n_fresh] = fs[_LOG_F, fresh]
                log_i[0, retired:retired + n_fresh] = torch.clamp(
                    ints[_STEPS, fresh], max=_STEPS_MAX)
                log_i[1:, retired:retired + n_fresh] = \
                    ints[[_SEGS, _PID], fresh]
                retired += n_fresh

            # ---- regenerate: refill dead lanes from the path pool ----
            dead = ~alive
            new_id = next_path + torch.cumsum(dead, 0) - 1
            can = dead & (new_id < n_paths)
            new_id = torch.clamp(new_id, max=n_paths - 1)
            ray_new, seed_new = spawn(new_id)
            fresh_f = torch.cat([torch.stack([*ray_new.o, *ray_new.d]),
                                 spawn_f[:, :size]])
            fresh_i = torch.cat([torch.stack([*seed_new, new_id]),
                                 spawn_i[:, :size]])
            fs = torch.where(can, fresh_f, fs)
            ints = torch.where(can, fresh_i, ints)
            active = alive | can
            if march:  # the next round's candidates and queues
                es, ss, queue = march_candidates(fs, ints, active)
            nact = n_alive + min(size - n_alive, n_paths - next_path)
            next_path = min(next_path + size - n_alive, n_paths)
            iters += 1
            lane_slots += size

    if use_log:
        # Every path retired exactly once: index the log by path id.
        pos = torch.empty(n_paths, dtype=torch.int64, device=dev)
        pos[log_i[2, :n_paths]] = torch.arange(n_paths, device=dev)
        vals, steps, segs = log_f[:, pos], log_i[0, pos], log_i[1, pos]
    else:
        vals = out_f[:, :n_paths]
        steps, segs = out_i[0, :n_paths], out_i[1, :n_paths]

    # Samples of a pixel: the standard renderer's reduction.
    per = [slice(k * n_pix, (k + 1) * n_pix) for k in range(config.spp)]
    acc = torch.zeros((3, n_pix), dtype=torch.float32, device=dev)
    depth = vals[3, per[0]]
    for p in per:
        acc = acc + vals[0:3, p]
        depth = torch.minimum(depth, vals[3, p])
    rgb = acc * (1.0 / config.spp)
    aovs = FrameAOVs(
        radiance=rgb.T.reshape(h, w, 3),
        depth=depth.reshape(h, w),
        steps=sum(steps[p] for p in per).to(torch.int32).reshape(h, w),
        segments=sum(segs[p] for p in per).to(torch.int32).reshape(h, w),
        normal=vals[4:7, per[0]].T.reshape(h, w, 3))
    render_radiance_regen.iterations += iters
    if return_stats:
        return aovs, {"iters": iters, "lane_slots": lane_slots,
                      "it_alive": it_alive, "it_sweeps_a": it_sweeps[0],
                      "it_sweeps_b": it_sweeps[1], "n_blocks": nw // BN}
    return aovs


render_radiance_regen.iterations = 0
