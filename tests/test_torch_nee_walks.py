"""The counts of kernels 4 and 10, which run the block-cooperative flat
closest-hit walk and then the any-hit walk (csrc/trace_common.cuh
``walk_flat_coop``, ``walk_any_coop``), as their plain versions report
them: ``ops.intersect.closest_hit_rows_nee_plain(counts=)`` and
``ops.megakernel.mega_step_plain(counts=)``.

Each is the sum of the two walks' counts (``closest_hit_rows_plain`` and
``occluded_plain``), and row 47 of kernel 4 counts the chunks whose gate
some still unresolved shadow ray of the block passes, whether or not it
passes a half's: hand-built gates pin that meaning, which the CUDA
kernel's counter must match bit for bit (tests/test_torch_cuda.py). Nothing
here runs JAX: the counts belong to the port's kernels alone.
"""

from __future__ import annotations

import pytest
import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.ops import megakernel as mk
from gdpathtracing_torch.ops import tiles as kt
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera

torch.set_num_threads(1)
SLOT = ti.BN * ti.BT  # a thread per ray: every lane on a staged chunk


@pytest.fixture(scope="module")
def demo():
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6,
                             device="cpu")
    return scene, ti.prepare_trace_inputs(scene)


def _tile_operands(scene, prep, n=512):
    """Kernel 4's operands on a demo tile (pixels of row 300, which see
    the room): one bounce from the primary hits, with the shadow queries
    posted from those hits."""
    cfg = RenderConfig(tile_rays=n)
    _, hit, s, seed = kt.middle_rays(scene, demo_camera(kt.W, kt.H), prep,
                                     cfg, n, kt.W * 300 + 700)
    bounce, active = kt.bounce_rays(s, hit, seed, cfg)
    pend = kt.shadow_queries(s, hit, seed, prep, cfg)
    return kt.rows_nee_operands(prep, bounce, active, pend)


def test_rows_nee_counts_are_the_walks_sum(demo):
    scene, prep = demo
    args = _tile_operands(scene, prep)
    o4t, d4t, so4t, sd4t, stmax, bounds, sub_bounds, mu, mv, mw, tab = args
    counts = {}
    rows, occ = ti.closest_hit_rows_nee_plain(*args, counts=counts)

    closest = {}
    rows_1 = ti.closest_hit_rows_plain(o4t, d4t, bounds, mu, mv, mw, tab,
                                       counts=closest)
    shadow_counts = {}
    shadow = ti.occluded_plain(so4t, sd4t, stmax, bounds, sub_bounds, mu, mv,
                               mw, counts=shadow_counts)
    assert torch.equal(rows[:47], rows_1[:47])
    assert torch.equal(rows[47], shadow.sweeps)
    assert torch.equal(occ, shadow.occ)
    assert 0 < int(occ.sum()) < int((stmax > 0).sum())
    n, nc = o4t.shape[1], bounds.shape[1]
    assert counts == {
        "tests": float(rows_1[45].sum()) + float(shadow.tests.sum()),
        "slab_tests": n * nc + shadow_counts["slab_tests"],
        "slots": closest["slots"] + shadow_counts["slots"],
        "thread_slots": closest["thread_slots"]
        + shadow_counts["thread_slots"]}
    assert shadow_counts["thread_slots"] == \
        float(shadow.sweeps[::ti.BN].sum()) * SLOT
    assert 0 < counts["tests"] <= counts["slots"] <= counts["thread_slots"]


# Hand-built any-hit gates: rays from the origin along x, three chunks
# whose boxes hold the origin. Chunk 0's triangle 0 lies in the plane
# x = -1 (a ray toward -x hits it at t = 1, u = v = 0.25); every other
# triangle is all zero rows and never hits. Chunk 2's halves lie off the
# x axis, so a ray enters chunk 2's box but neither half's.
BIG = (-1e3, -1e3, -1e3, 1e3, 1e3, 1e3, 0.0, 0.0)
OFF_AXIS = (-1.0, 50.0, -1.0, 1.0, 51.0, 1.0, 0.0, 0.0)
# (direction x, limit) of the one ray of each block that is not parked,
# or None for a block of parked rays, and the block's row 47 and tests.
BLOCKS = [
    ((-1.0, 10.0), 1, ti.SW),       # blocked in chunk 0's first half: the
    #                                 later chunks no longer count
    ((1.0, 10.0), 3, 2 * ti.BT),    # chunks 0 and 1 swept, chunk 2 entered
    #                                 (row 47) but no half of it tested
    (None, 0, 0),                   # parked
    ((1.0, 0.0), 0, 0),             # at the origin, inside every box, but
    #                                 limit 0: unresolved never, tests none
]


def _hand_built():
    n = len(BLOCKS) * ti.BN
    o4t = torch.zeros(4, n)
    d4t = torch.zeros(4, n)
    o4t[3] = 1.0
    o4t[:3] = 1e9
    d4t[:3] = 0.5773503
    tlim = torch.zeros(n)
    for b, (ray, _, _) in enumerate(BLOCKS):
        if ray is not None:
            i = b * ti.BN + 5
            o4t[:3, i] = 0.0
            d4t[:3, i] = torch.tensor([ray[0], 0.0, 0.0])
            tlim[i] = ray[1]
    bounds = torch.tensor([BIG, BIG, BIG]).T.contiguous()
    sub_bounds = torch.tensor([BIG, BIG, BIG, BIG, OFF_AXIS, OFF_AXIS]
                              ).T.contiguous()
    e = 3 * ti.BT
    mu, mv, mw = (torch.zeros(4, e) for _ in range(3))
    mu[:, 0] = torch.tensor([0.0, 1.0, 0.0, 0.25])
    mv[:, 0] = torch.tensor([0.0, 0.0, 1.0, 0.25])
    mw[:, 0] = torch.tensor([1.0, 0.0, 0.0, 1.0])
    return o4t, d4t, tlim, bounds, sub_bounds, mu, mv, mw


def test_row_47_counts_chunk_gates_of_unresolved_rays():
    o4t, d4t, tlim, bounds, sub_bounds, mu, mv, mw = _hand_built()
    res = ti.occluded_plain(o4t, d4t, tlim, bounds, sub_bounds, mu, mv, mw)
    blocks = range(len(BLOCKS))
    assert res.sweeps[::ti.BN].tolist() == [float(BLOCKS[b][1])
                                            for b in blocks]
    assert [float(res.tests.view(-1, ti.BN)[b].sum()) for b in blocks] \
        == [float(BLOCKS[b][2]) for b in blocks]
    assert res.occ.nonzero().squeeze(1).tolist() == [5]

    # Kernel 4 with these as its shadow rays (and parked bounce rays):
    # row 47 is that count; its chunk sweeps spend no slot where no ray
    # tests a half.
    tab = torch.zeros(ti.TAB_R, mu.shape[1])
    parked = torch.zeros_like(o4t) + 1e9, torch.zeros_like(d4t) + 0.5773503
    counts = {}
    rows, occ = ti.closest_hit_rows_nee_plain(
        *parked, o4t, d4t, tlim, bounds, sub_bounds, mu, mv, mw, tab,
        counts=counts)
    assert torch.equal(rows[47], res.sweeps) and torch.equal(occ, res.occ)
    assert not rows[45:47].any()
    # One needing ray a block: a warp tests 128 triangles a half it needs.
    assert counts["slots"] == float(ti.WARPS * (ti.SW + 2 * ti.BT))
    assert counts["thread_slots"] == float(sum(b[1] for b in BLOCKS)) * SLOT
    assert counts["tests"] == float(ti.SW + 2 * ti.BT)


def _mega_state(scene, n_live_blocks, n_dead_blocks):
    """Kernel 10's packed state: the camera paths of ``n_live_blocks``
    256-ray blocks of a demo tile, then ``n_dead_blocks`` blocks of dead
    paths (copies of the tile's first block, active 0)."""
    cfg = RenderConfig(tile_rays=ti.BN)
    ray, seed = kt.camera_rays(demo_camera(kt.W, kt.H), cfg,
                               max(n_live_blocks, 1) * ti.BN,
                               kt.W * 300 + 700, "cpu")
    fs, is_ = mk.pack_state(ray, seed)
    dead_fs = fs[:, :ti.BN].repeat(1, n_dead_blocks)
    dead_fs[12] = 0.0
    n = n_live_blocks * ti.BN
    return (torch.cat([fs[:, :n], dead_fs], dim=1).contiguous(),
            torch.cat([is_[:, :n], is_[:, :ti.BN].repeat(1, n_dead_blocks)],
                      dim=1).contiguous())


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_mega_counts_are_the_walks_sum(demo, monkeypatch, nee):
    """mega_step_plain's slots are those of its two walks, as
    closest_hit_rows_plain and occluded_plain count them; a block of dead
    paths (parked rays, which pass no gate) adds none, so the state with
    two dead blocks appended counts what the live blocks alone do."""
    scene, prep = demo
    cfg = RenderConfig(traversal=Traversal.MEGA, nee=nee)
    lt = mk._build_light_block(prep.lights if nee else None, "cpu")
    geo = (prep.bounds, prep.sub_bounds, prep.mu, prep.mv, prep.mw,
           prep.tab, lt)
    seen = []

    def spy(fn):
        def wrapped(*args, counts=None):
            out = fn(*args, counts=counts)
            seen.append(dict(counts))
            return out
        return wrapped

    monkeypatch.setattr(mk, "closest_hit_rows_plain",
                        spy(ti.closest_hit_rows_plain))
    monkeypatch.setattr(mk, "occluded_plain", spy(ti.occluded_plain))
    totals = []
    for dead in (0, 2):
        seen.clear()
        counts = {}
        state = _mega_state(scene, 2, dead)
        for b in (0, 1):
            state = mk.mega_step_plain(*state, *geo, b, cfg, counts=counts)
        assert len(seen) == (4 if nee else 2)
        for key in ("slots", "thread_slots"):
            assert counts[key] == sum(c[key] for c in seen)
        totals.append(counts)
    assert totals[0] == totals[1]
    assert 0 < totals[0]["tests"] <= totals[0]["slots"] \
        <= totals[0]["thread_slots"]
    assert ("shadow_rays" in totals[0]) == nee


def test_mega_counts_nothing_for_dead_blocks(demo):
    scene, prep = demo
    cfg = RenderConfig(traversal=Traversal.MEGA, nee=True)
    lt = mk._build_light_block(prep.lights, "cpu")
    state = _mega_state(scene, 0, 2)
    counts = {}
    fs, is_ = mk.mega_step_plain(*state, prep.bounds, prep.sub_bounds,
                                 prep.mu, prep.mv, prep.mw, prep.tab, lt, 0,
                                 cfg, counts=counts)
    assert counts == {"tests": 0.0, "slots": 0.0, "thread_slots": 0.0,
                      "shadow_rays": 0}
    assert torch.equal(fs, state[0]) and torch.equal(is_, state[1])
