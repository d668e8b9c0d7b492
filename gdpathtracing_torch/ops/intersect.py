"""Ray traversal over the chunked expanded-triangle list.

Port of the PALLAS traversal of gdpathtracing_tpu/ops/intersect_pallas.py:
``build_trace_table``, ``_inflate_bounds``, ``_sub_bounds``,
``prepare_trace_inputs`` (flat and superchunk), ``trace_pallas``,
``lite_epilogue``, ``occluded_pallas``, ``trace_occlude_pallas``, their
differentiable forms ``trace_pallas_diff`` and ``trace_occlude_pallas_diff``
(``_diff_epilogue``), ``soft_occluded_pallas``, regen's frontier march
(``march_sweep`` and, as torch ops outside any kernel, like the reference's
XLA, ``march_next_candidates``, ``march_block_queue`` and
``march_supported``) and ``trace_pallas_classic``, over nine kernels of the
TPU package, each here a wrapper that

- on a CUDA tensor launches a hand-written kernel from ``csrc/`` (built by
  nvcc at first use, ops/build.py) and counts the launch in ``.launches``;
- on a CPU tensor runs the kernel's plain PyTorch version, which the CPU
  tests hold against JAX and ``chip_smoke.py`` holds against the kernel on
  the card.

The wrappers, with the TPU kernel each replaces (intersect_pallas.py) and
its CUDA source (csrc/):

- ``closest_hit_rows``: ``_kernel_rows`` + ``_sweep_update``;
  closest_hit_rows.cu
- ``occluded``: ``_occlusion_kernel``; occlusion.cu
- ``closest_hit_rows_nee``: ``_kernel_rows_nee`` (the two fused);
  closest_hit_rows_nee.cu
- ``closest_hit_sc_lite``: ``_kernel_sc_lite`` + ``_lite_sc_sweep``;
  closest_hit_sc_lite.cu
- ``closest_hit_rows_sc``: ``_kernel_rows_sc``; closest_hit_rows_sc.cu
- ``soft_occluded``: ``_soft_occlusion_kernel`` (the top-1 blocker of a
  soft shadow ray); soft_occlusion.cu
- ``march_step_sc``: ``_kernel_sc_march`` (one march round: kernel 3's
  superchunk walk over each block's queue, from a carried best);
  march_step_sc.cu
- ``closest_hit_classic`` and ``closest_hit_loop``: ``_kernel`` and
  ``_kernel_loop`` (the classic (t, idx) closest hit over the raw chunk
  boxes, gated per ray and per block); closest_hit_classic.cu

The kernels find; they are not differentiated. Every wrapper, and
``prepare_trace_inputs``, runs under ``torch.no_grad()`` and refuses an
operand that requires grad (on either device, so the CPU and the card
behave alike). The differentiable forms run a kernel on detached inputs and
recompute the winner's t, u, v (or soft coverage) from the live
``scene.isect_cols`` with ordinary torch ops, through which autograd flows,
as the reference does with ``stop_gradient``: no kernel has a backward.

Scenes of at most 16 chunks take the flat kernels; larger ones the
two-level (superchunk) kernels for the closest hit, and the flat occlusion
kernel over the unpadded chunks for shadow rays, as the reference does.
The TPU kernels visit chunks near-to-far from a per-block queue; neither
the closest-hit winner nor the any-hit answer depends on visit order, so
every version here walks the chunks in index order (only the ``steps`` row
and the sweep telemetry see the difference). Kernel 7 walks the
superchunks its block's queue names, in queue order, from a carried best.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gdpathtracing_torch.render.lights import LightTable, build_light_table
from gdpathtracing_torch.render.shading import material_table
from gdpathtracing_torch.render.types import MISS_T, HitInfo, Ray
from gdpathtracing_torch.scene.scene import Scene
from gdpathtracing_torch.utils.telemetry import SPANS, launched

BN = 256     # rays per kernel block
WARPS = BN // 32  # warps per kernel block
BT = 256     # triangles per chunk
TAB_R = 40   # winner-table rows
OUT_R = 48   # output rows: 0:40 table | 40 t | 41 u | 42 v | 43 w_d |
#              44 eidx | 45 triangles swept by the ray | 46 chunks swept
#              by its 256-ray block | 47 chunks the block swept for
#              shadow rays (closest_hit_rows_nee; zero otherwise). The
#              superchunk rows kernel counts superchunks its block entered
#              in 46 and chunks its block swept in 47.
LITE_R = 8   # superchunk lite rows: 0 t | 1 eidx (exact f32) | 2 triangles
#              swept by the ray | 3 superchunks its block entered | 4-7 zero
FS_R = 24    # the path kernels' operands (ops/megakernel.py,
IS_R = 8     # ops/fused.py): packed f32 and i32 path state rows, light-block
LT_R = 18    # columns, winner-table and material-row widths
TABLE_W = 32
MAT_W = 16
SUB = 2      # sub-chunks per chunk: a shadow ray tests each 128-triangle
SW = BT // SUB  # half's own box before sweeping it
GW = 32      # triangles per group: kernel 3 sweeps a chunk's 32-triangle
GROUPS = BT // GW  # groups whose own boxes a ray's gate passes
MAX_FLAT_CHUNKS = 16  # larger scenes take the superchunk kernels
SCC = 8      # chunks per superchunk (raised to keep nsc <= ~100)
# Dispatch of superchunk scenes, mirrored from the reference so that the
# port takes the same kernel on every scene: the lite kernel (3) while the
# (4, 3·E) triangle rows fit _SC_RESIDENT_BYTES, else the rows kernel (6).
# These are the TPU's VMEM figures (a v5e core's 16 MB, halved); whether
# the H100 wants another threshold is open (PERF.md §7).
_SC_LITE = True
_SC_RESIDENT_BYTES = 8 << 20
_WD_EPS = 1e-12
_MISS = 1e9


def build_trace_table(scene: Scene, lights: LightTable | None = None
                      ) -> torch.Tensor:
    """(40, E) f32 per-expanded-triangle table:

      0:9   world shading normals n0, n1, n2
      9:15  uv0, uv1, uv2
      15    global triangle index (float-exact below 2^24)
      16    instance index
      17:30 material row [albedo3, emission3, energy, metallic, roughness,
            tex, transmission, ior, mr_tex]
      30    NEE pdf term pick_prob/area (0 = not an emitter)
      31:34 emitter geometric normal
      34:40 zero padding

    ``lights`` is the scene's light table (built here when not given).
    """
    shade = scene.isect_shade  # (E, 16)
    e = shade.shape[0]
    mats = material_table(scene)[shade[:, 15].to(torch.int64)]

    if scene.n_lights > 0:
        lt = lights if lights is not None else build_light_table(scene)
        li = torch.clamp(scene.isect_light, 0, lt.area.shape[0] - 1).long()
        is_l = (scene.isect_light >= 0).to(torch.float32)
        inv_term = (lt.pick_prob[li] / torch.clamp(lt.area[li], min=1e-8)) \
            * is_l
        light_cols = torch.stack([inv_term, lt.normal.x[li] * is_l,
                                  lt.normal.y[li] * is_l,
                                  lt.normal.z[li] * is_l], dim=1)
    else:
        light_cols = shade.new_zeros((e, 4))

    tab = torch.cat([
        shade[:, 0:15],
        scene.isect_tri.to(torch.float32)[:, None],
        scene.isect_inst.to(torch.float32)[:, None],
        mats,
        light_cols,
        shade.new_zeros((e, TAB_R - 34)),
    ], dim=1)  # (E, 40)
    return tab.T.contiguous()


def _rcp(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(d) < 1e-30, 1e-30, d)


def _inflate_bounds(cb: torch.Tensor) -> torch.Tensor:
    """(8, nc) chunk bounds → copy inflated by ~100 ulp, so a ray whose
    triangle hit the sweep would find always passes its own slab test."""
    lo, hi, pad = cb[0:3], cb[3:6], cb[6:8]
    eps = 1e-5 * torch.maximum(torch.abs(lo), torch.abs(hi)) + 1e-6
    return torch.cat([lo - eps, hi + eps, pad], dim=0)


def _vertex_bounds(scene: Scene) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, 3) lowest and highest world-space vertex coordinates of every
    expanded triangle; +inf and -inf for pad and degenerate triangles
    (zero unit-space columns), so that they widen no box."""
    tf = scene.inst_transform[scene.isect_inst.long()]    # (E, 3, 4)
    tp = scene.tri_pos[scene.isect_tri.long()]            # (E, 3, 3) object
    world = (tf[:, None, :, 0] * tp[:, :, 0:1] + tf[:, None, :, 1]
             * tp[:, :, 1:2] + tf[:, None, :, 2] * tp[:, :, 2:3]
             + tf[:, None, :, 3])                         # (E, 3, 3) world
    real = (torch.abs(scene.isect_mu).sum(dim=0) > 0.0)[:, None]
    return (torch.where(real, world.amin(dim=1), torch.inf),
            torch.where(real, world.amax(dim=1), -torch.inf))


def _span_bounds(lo: torch.Tensor, hi: torch.Tensor, width: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lowest and highest corners (n / width, 3) of each ``width``
    consecutive rows of ``lo``/``hi`` (n, 3); ±inf where every row is."""
    return (lo.view(-1, width, 3).amin(dim=1),
            hi.view(-1, width, 3).amax(dim=1))


def _span_boxes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(8, n) inflated boxes from corners ``lo``/``hi`` (n, 3); an empty
    span (±inf corners) becomes a point box at 1e30 that no slab passes."""
    empty = ~torch.isfinite(lo[:, :1])
    lo = torch.where(empty, 1e30, lo)
    hi = torch.where(empty, 1e30, hi)
    pad = lo.new_zeros((lo.shape[0], 2))
    return _inflate_bounds(torch.cat([lo, hi, pad], dim=1).T)


def _sub_bounds(scene: Scene) -> torch.Tensor:
    """(8, SUB·nc) inflated AABBs of the 128-triangle halves of every chunk
    (half s of chunk c is column c·SUB + s), from world-space vertices.
    Pad and degenerate triangles (zero unit-space columns) do not widen a
    box; an all-pad half gets a point box far away that no slab passes."""
    return _span_boxes(*_span_bounds(*_vertex_bounds(scene), SW))


class TracePrep(NamedTuple):
    """Kernel-ready trace inputs, built once per scene."""
    mu: torch.Tensor      # (4, E) unit-space rows (the flat kernels)
    mv: torch.Tensor
    mw: torch.Tensor
    tab: torch.Tensor     # (40, E_pad) winner table
    bounds: torch.Tensor  # (8, nc) inflated chunk AABBs
    sub_bounds: torch.Tensor  # (8, SUB·nc) inflated sub-chunk AABBs
    lights: LightTable | None  # NEE light table (None without emitters)
    superchunks: bool     # more than MAX_FLAT_CHUNKS chunks
    # The superchunk kernels' operands (on a flat scene, the flat ones):
    mu_pad: torch.Tensor  # (4, E_pad), E_pad = 256·nc_pad, zero columns
    mv_pad: torch.Tensor  # for the pad chunks
    mw_pad: torch.Tensor
    chunk_bounds: torch.Tensor  # (8, nc_pad) inflated; pad chunks are
    #                             point boxes at 1e30 that no slab passes
    sc_bounds: torch.Tensor     # (8, nsc) inflated superchunk AABBs
    #                             (8, 0) on a flat scene
    group_bounds: torch.Tensor  # (8, 8·nc_pad) inflated AABBs of the
    #                             32-triangle groups of the padded chunks
    #                             (group q of chunk c is column c·8 + q;
    #                             kernel 3's operand); (8, 0) on a flat
    #                             scene
    scc: int                    # chunks per superchunk, nc_pad = nsc·scc
    tri_inst: torch.Tensor      # (E, 2) i32 [tri | inst] of each triangle

    @property
    def m3_bytes(self) -> int:
        """Bytes of the reference's interleaved (4, 3·E_pad) triangle
        rows, which its superchunk dispatch compares with
        ``_SC_RESIDENT_BYTES``."""
        return 4 * 3 * self.mu_pad.shape[1] * 4


@torch.no_grad()
def prepare_trace_inputs(scene: Scene) -> TracePrep:
    """The kernels' inputs. A scene of more than 16 chunks is padded to
    whole superchunks of ``scc`` chunks (``SCC``, raised to keep at most
    ~100 superchunks, as the reference does for its queue): zero triangle
    columns, a 1e30 point box for each pad chunk, and superchunk boxes
    around the real chunks only. Built from the detached scene: every
    field is a kernel operand or read with the kernels' results."""
    scene = scene.detach()
    e = scene.isect_mu.shape[1]
    if e >= 2 ** 24:
        raise ValueError(f"scene has {e} expanded triangles; ids ride the "
                         f"f32 rows and are exact only below 2^24")
    nc = e // BT
    scc = max(SCC, -(-nc // 100))
    lights = build_light_table(scene)
    tab = build_trace_table(scene, lights)
    mu, mv, mw = (x.contiguous() for x in (scene.isect_mu, scene.isect_mv,
                                             scene.isect_mw))
    cb = scene.isect_chunk_bounds
    bounds = _inflate_bounds(cb).contiguous()
    tri_inst = torch.stack([scene.isect_tri, scene.isect_inst],
                           dim=1).to(torch.int32)
    flat = dict(mu=mu, mv=mv, mw=mw, bounds=bounds, lights=lights,
                tri_inst=tri_inst)
    if nc <= MAX_FLAT_CHUNKS:
        none = bounds.new_zeros((8, 0))
        return TracePrep(tab=tab, superchunks=False, mu_pad=mu, mv_pad=mv,
                         mw_pad=mw, chunk_bounds=bounds, sc_bounds=none,
                         group_bounds=none, scc=scc,
                         sub_bounds=_sub_bounds(scene).contiguous(), **flat)

    nc_pad = -(-nc // scc) * scc
    nsc = nc_pad // scc
    # The world-space vertices are reduced once, to the 32-triangle groups;
    # kernel 2's halves are the groups' (a min of mins is the same bits).
    # Both sets are inflated in one pass, the pad chunks' groups as empty.
    glo, ghi = _span_bounds(*_vertex_bounds(scene), GW)
    hlo, hhi = _span_bounds(glo, ghi, SW // GW)
    n_empty = GROUPS * (nc_pad - nc)
    boxes = _span_boxes(
        torch.cat([hlo, glo, glo.new_full((n_empty, 3), torch.inf)]),
        torch.cat([hhi, ghi, ghi.new_full((n_empty, 3), -torch.inf)]))
    ns = hlo.shape[0]

    def pad(x):
        return torch.nn.functional.pad(x, (0, (nc_pad - nc) * BT)
                                       ).contiguous()

    pad_box = cb.new_zeros((8, nc_pad - nc))
    pad_box[0:6] = 1e30
    cb_pad = torch.cat([cb, pad_box], dim=1)
    real = (torch.arange(nc_pad, device=cb.device) < nc)[None, :]
    mins = torch.where(real, cb_pad[0:3], torch.inf).view(3, nsc, scc)
    maxs = torch.where(real, cb_pad[3:6], -torch.inf).view(3, nsc, scc)
    sc = torch.cat([mins.amin(dim=2), maxs.amax(dim=2),
                    cb.new_zeros((2, nsc))], dim=0)
    return TracePrep(tab=pad(tab), superchunks=True, mu_pad=pad(mu),
                     mv_pad=pad(mv), mw_pad=pad(mw),
                     chunk_bounds=_inflate_bounds(cb_pad).contiguous(),
                     sc_bounds=_inflate_bounds(sc).contiguous(), scc=scc,
                     sub_bounds=boxes[:, :ns].contiguous(),
                     group_bounds=boxes[:, ns:].contiguous(), **flat)


# ---------------------------------------------------------------------------
# Shared by the kernels: input checks, launch, the slab test
# ---------------------------------------------------------------------------

# Operands the kernels take as int32 (ops/megakernel.py, ops/fused.py);
# every other operand is float32.
_INT_OPERANDS = ("istate", "seeds", "queue")


def _check_inputs(scc: int = 1, **args) -> tuple[int, int]:
    """Check the kernel operands named in ``args`` (dtype, device, layout,
    shape) and return (N, E). N rays come from ``o4t`` (or the path state
    ``fstate``), E triangles from ``mu``; the two-level kernels'
    ``sc_bounds`` hold one box per ``scc`` chunks; the light block ``lt``,
    the material rows ``mats`` and the march ``queue`` may have any
    length."""
    rays = args["o4t"] if "o4t" in args else args["fstate"]
    mu = args["mu"]
    dev = rays.device
    for name, x in args.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        want_dtype = torch.int32 if name in _INT_OPERANDS else torch.float32
        if x.dtype != want_dtype:
            raise TypeError(f"{name} must be {want_dtype}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the rays on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.requires_grad:
            raise ValueError(f"{name} requires grad: the kernels only find "
                             f"hits; pass detached operands (see "
                             f"trace_pallas_diff)")
    n = rays.shape[1] if rays.dim() == 2 else -1
    e = mu.shape[1] if mu.dim() == 2 else -1
    nc = e // BT
    if not isinstance(scc, int) or scc < 1 or nc % scc:
        raise ValueError(f"scc={scc!r} must be a positive int dividing the "
                         f"{nc} chunks")
    want = dict(o4t=(4, n), d4t=(4, n), so4t=(4, n), sd4t=(4, n),
                tlim=(n,), stmax=(n,), tmax=(n,), eo=(3, e), bounds=(8, nc),
                sub_bounds=(8, SUB * nc), sc_bounds=(8, nc // scc),
                group_bounds=(8, GROUPS * nc),
                mu=(4, e), mv=(4, e), mw=(4, e), tab=(TAB_R, e),
                fstate=(FS_R, n), istate=(IS_R, n), seeds=(2, n),
                init=(2, n), queue=(None,),
                lt=(None, LT_R), table=(e, TABLE_W), mats=(None, MAT_W))
    for name, x in args.items():
        if x.dim() != len(want[name]) or any(
                w is not None and w != k for w, k in zip(want[name], x.shape)):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {want[name]}")
    if n <= 0 or n % BN or e <= 0 or e % BT:
        raise ValueError(f"need N % {BN} == 0 and E % {BT} == 0 "
                         f"(N={n}, E={e})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return n, e


@functools.lru_cache(maxsize=None)
def _c_function(name: str, n_ptrs: int, n_ints: int, n_floats: int = 0,
                source: str | None = None):
    """The C entry point ``name`` of ``csrc/<source>.cu`` (``source``
    defaults to ``name``): ``n_ptrs`` device pointers, ``n_ints`` ints (N,
    E and any more the kernel takes), ``n_floats`` floats, then the stream;
    returns a cudaError_t."""
    from gdpathtracing_torch.ops.build import load_library

    fn = getattr(load_library(source or name).lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
        + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, tensors: tuple, *ints: int, wrapper,
            floats: tuple = (), source: str | None = None) -> None:
    """Launch kernel ``name`` (of ``csrc/<source>.cu``, by default
    ``<name>.cu``) on the current stream (no synchronisation) with the
    ``tensors``' pointers, the ``ints`` and the ``floats`` (each passed as
    the float32 nearest to it, as PyTorch takes a Python float into a
    float32 op), counted in ``wrapper.launches`` and stamped as
    ``<name>_kernel`` (utils/telemetry.py ``launched``); raise if the
    launch was refused."""
    dev = tensors[0].device
    fn = _c_function(name, len(tensors), len(ints), len(floats), source)
    with torch.cuda.device(dev):
        args = (*(t.data_ptr() for t in tensors), *ints, *floats,
                torch.cuda.current_stream(dev).cuda_stream)
        launched(wrapper, f"{name}_kernel")
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _slab(b, ox, oy, oz, rdx, rdy, rdz):
    """(tmin, tmax) of every ray against the box ``b`` = (8,) [min3 | max3
    | pad2]; the term order of csrc/trace_common.cuh ``slab``."""
    tx1 = (b[0] - ox) * rdx
    tx2 = (b[3] - ox) * rdx
    ty1 = (b[1] - oy) * rdy
    ty2 = (b[4] - oy) * rdy
    tz1 = (b[2] - oz) * rdz
    tz2 = (b[5] - oz) * rdz
    tmin = torch.maximum(torch.maximum(torch.minimum(tx1, tx2),
                                       torch.minimum(ty1, ty2)),
                         torch.minimum(tz1, tz2))
    tmax = torch.minimum(torch.minimum(torch.maximum(tx1, tx2),
                                       torch.maximum(ty1, ty2)),
                         torch.maximum(tz1, tz2))
    return tmin, tmax


def _dot4(m, x0, x1, x2, x3):
    """(4, k) triangle rows x (r,) rays -> (r, k), summed left to right."""
    return x0[:, None] * m[0] + x1[:, None] * m[1] + \
        x2[:, None] * m[2] + x3[:, None] * m[3]


def _uvt(cols, mu, mv, mw, o, d):
    """u, v, t and w_d of rays ``o``/``d`` (4-tuples of (r,)) against the
    triangles ``cols`` -> each (r, len(cols)); t is taken with w_d = 1
    where |w_d| <= 1e-12 (never a hit)."""
    w_d = _dot4(mw[:, cols], *d)
    w_o = _dot4(mw[:, cols], *o)
    wd_ok = torch.abs(w_d) > _WD_EPS
    t = -w_o / torch.where(wd_ok, w_d, 1.0)
    u = _dot4(mu[:, cols], *o) + t * _dot4(mu[:, cols], *d)
    v = _dot4(mv[:, cols], *o) + t * _dot4(mv[:, cols], *d)
    return u, v, t, w_d, wd_ok


# ---------------------------------------------------------------------------
# Kernel 1: closest hit + winner rows
# ---------------------------------------------------------------------------

def _block_any(mask: torch.Tensor) -> torch.Tensor:
    """(N,) f32: 1 on every ray of a 256-ray block where any ray of it has
    ``mask`` set."""
    return mask.view(-1, BN).any(dim=1).repeat_interleave(BN).to(
        torch.float32)


class _ClosestWalk:
    """State of the plain closest-hit walks: each ray's best (t, eidx) with
    its u, v and w_d, and the triangles it swept. The chunk sweep repeats
    csrc/trace_common.cuh ``sweep_closest``: the same per-ray gate, the
    same term order in every dot product, elementwise products only (no
    matmul, so no TF32), run only on the rays whose gate passed, so
    temporaries are (rays, 256), never (rays, E)."""

    def __init__(self, o4t, d4t, best_t=None, best_e=None):
        """Rays ``o4t``/``d4t`` (4, N); each ray's best so far is
        (``best_t``, ``best_e``) when given (a march round's carried best),
        else no hit (1e9, 0)."""
        n = o4t.shape[1]
        self.o = o4t.unbind(0)
        self.d = d4t.unbind(0)
        self.rd = tuple(_rcp(x) for x in self.d[:3])
        self.best_t = torch.full((n,), _MISS, dtype=torch.float32,
                                 device=o4t.device) if best_t is None \
            else best_t.clone()
        self.best_e = torch.zeros(n, dtype=torch.int64, device=o4t.device) \
            if best_e is None else best_e.to(torch.int64, copy=True)
        self.best_u = torch.zeros_like(self.best_t)
        self.best_v = torch.zeros_like(self.best_t)
        self.best_wd = torch.zeros_like(self.best_t)
        self.steps = torch.zeros_like(self.best_t)
        self.lane = torch.arange(BT, device=o4t.device)

    def passes(self, box) -> torch.Tensor:
        """(N,) bool: the ray's slab test against ``box`` (8,) passes
        before its best t so far."""
        tmin, tmax = _slab(box, *self.o[:3], *self.rd)
        return (tmax >= tmin) & (tmax > 0.0) & (tmin <= self.best_t)

    def sweep(self, c, may, mu, mv, mw) -> None:
        """Sweep chunk ``c`` for the rays where ``may`` is set."""
        idx = torch.nonzero(may).squeeze(1)
        if idx.numel() == 0:
            return
        self.steps[idx] += float(BT)
        u, v, t, w_d, wd_ok = _uvt(slice(c * BT, (c + 1) * BT), mu, mv, mw,
                                   tuple(x[idx] for x in self.o),
                                   tuple(x[idx] for x in self.d))
        valid = wd_ok & (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        t = torch.where(valid, t, _MISS)
        tk = torch.amin(t, dim=1)
        # Lowest index among equal minima (torch.min's index is not
        # guaranteed to be the first on every device).
        k = torch.where(t == tk[:, None], self.lane, BT).amin(dim=1)
        ek = k + c * BT
        cur_t, cur_e = self.best_t[idx], self.best_e[idx]
        better = (tk < cur_t) | ((tk == cur_t) & (tk < _MISS) & (ek < cur_e))
        sel, kb = idx[better], k[better][:, None]
        self.best_t[sel] = tk[better]
        self.best_e[sel] = ek[better]
        self.best_u[sel] = u[better].gather(1, kb)[:, 0]
        self.best_v[sel] = v[better].gather(1, kb)[:, 0]
        self.best_wd[sel] = w_d[better].gather(1, kb)[:, 0]

    def rows(self, tab, row46, row47) -> torch.Tensor:
        """The (48, N) output of the rows kernels (trace_common.cuh
        ``write_rows``)."""
        n = self.best_t.shape[0]
        out = torch.empty((OUT_R, n), dtype=torch.float32,
                          device=self.best_t.device)
        out[:TAB_R] = torch.where(self.best_t < _MISS, tab[:, self.best_e],
                                  0.0)
        out[40], out[41], out[42] = self.best_t, self.best_u, self.best_v
        out[43] = self.best_wd
        out[44] = self.best_e.to(torch.float32)
        out[45], out[46], out[47] = self.steps, row46, row47
        return out


class FlatWalk(NamedTuple):
    """What :func:`walk_flat_plain` finds for N rays."""
    walk: _ClosestWalk     # each ray's winner and triangles swept
    sweeps: torch.Tensor   # (N,) chunks its 256-ray block swept
    slots: torch.Tensor    # (N,) thread-slots its block spent in the
    #                        block-cooperative walk (:func:`two_level_slots`)


def walk_flat_plain(o4t, d4t, bounds, mu, mv, mw) -> FlatWalk:
    """Plain version of the flat closest-hit walk of kernels 1, 4, 10 and
    11 (csrc/trace_common.cuh ``walk_flat_coop``): chunks in index order,
    each ray gated by its own slab test against the chunk's inflated box
    before its best t so far. Also counts, per ray, the chunks its 256-ray
    block swept and the thread-slots the block spends on them under the
    cooperative mapping (:func:`two_level_slots` of each chunk's gates,
    summed over the chunks)."""
    walk = _ClosestWalk(o4t, d4t)
    sweeps = torch.zeros_like(walk.best_t)
    slots = torch.zeros_like(walk.best_t)
    for c in range(mu.shape[1] // BT):
        may = walk.passes(bounds[:, c])
        sweeps += _block_any(may)
        slots += two_level_slots(may).repeat_interleave(BN)
        walk.sweep(c, may, mu, mv, mw)
    return FlatWalk(walk, sweeps, slots)


def closest_hit_rows_plain(o4t, d4t, bounds, mu, mv, mw, tab,
                           counts: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract (see
    csrc/closest_hit_rows.cu): :func:`walk_flat_plain` and the winner's
    rows. ``counts``, when given, receives the thread-slots kernel 1's
    block-cooperative walk spends (``"slots"``) and those of a thread per
    ray (``"thread_slots"``: every lane of a block sweeps each chunk some
    ray of the block needs), summed over the blocks."""
    walk, sweeps, slots = walk_flat_plain(o4t, d4t, bounds, mu, mv, mw)
    if counts is not None:
        counts["slots"] = float(slots[::BN].sum())
        counts["thread_slots"] = float(sweeps[::BN].sum()) * BN * BT
    return walk.rows(tab, sweeps, 0.0)


@torch.no_grad()
def closest_hit_rows(o4t, d4t, bounds, mu, mv, mw, tab) -> torch.Tensor:
    """(48, N) closest-hit rows for rays ``o4t``/``d4t`` (4, N) over the
    chunked triangles ``mu``/``mv``/``mw`` (4, E) with inflated chunk
    ``bounds`` (8, E/256) and winner table ``tab`` (40, E).

    CUDA tensors launch the kernel (and count the launch in
    ``closest_hit_rows.launches``); CPU tensors run the plain version.
    Anything else raises."""
    n, e = _check_inputs(o4t=o4t, d4t=d4t, bounds=bounds, mu=mu, mv=mv,
                         mw=mw, tab=tab)
    if o4t.device.type == "cpu":
        return closest_hit_rows_plain(o4t, d4t, bounds, mu, mv, mw, tab)
    out = torch.empty((OUT_R, n), dtype=torch.float32, device=o4t.device)
    _launch("closest_hit_rows", (o4t, d4t, bounds, mu, mv, mw, tab, out),
            n, e, wrapper=closest_hit_rows)
    return out


closest_hit_rows.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: any-hit occlusion of shadow rays
# ---------------------------------------------------------------------------

class Occlusion(NamedTuple):
    """What :func:`occluded_plain` finds for each of N shadow rays."""
    occ: torch.Tensor     # (N,) int32: 1 when something blocks (0, tlim)
    tests: torch.Tensor   # (N,) f32 ray-triangle tests the ray needed
    sweeps: torch.Tensor  # (N,) f32 chunks its 256-ray block swept


def any_hit_slots(tests: torch.Tensor) -> torch.Tensor:
    """(N/256,) f32: the thread-slots each 256-ray block spends testing one
    staged chunk in csrc/trace_common.cuh ``walk_any_coop``, from each
    ray's tests of that chunk ``tests`` (N,): 128 for each half it tests,
    up to the first that blocks; 0 where it needs none. Entry i of the
    list of needing rays (the i-th in ray order) goes to warp i mod 8,
    which spends a slot a test (4 a lane per half), and the block waits for
    its busiest warp: 8 × that warp's sum; 0 where no ray needs the
    chunk."""
    need = (tests > 0).view(-1, BN)
    entry = torch.cumsum(need, dim=1) - 1
    per_warp = torch.zeros((need.shape[0], WARPS), dtype=tests.dtype,
                           device=tests.device).scatter_add_(
        1, torch.where(need, entry % WARPS, 0),
        torch.where(need, tests.view(-1, BN), 0.0))
    return (WARPS * per_warp.amax(dim=1)).to(torch.float32)


def occluded_plain(o4t, d4t, tlim, bounds, sub_bounds, mu, mv, mw,
                   counts: dict | None = None) -> Occlusion:
    """Plain PyTorch version of csrc/occlusion.cu: chunks in index order;
    a ray sweeps a chunk's 128-triangle half when its own slab tests
    against the inflated chunk box and the half's box pass with
    tmin < tlim, and stops at the first half that blocks it. A triangle
    blocks when |w_d| > 1e-12, 0 < t < tlim, u, v >= 0 and u + v <= 1.

    Also counts, per ray, the triangle tests these inputs need in that
    order (128 per half swept) and, per 256-ray block, the chunks on which
    some ray of the block with tlim > 0 and not yet occluded passes the
    chunk's gate, whether or not it passes a half's (kernel 4's row 47).
    ``counts``, when given, receives the thread-slots kernel 2's
    block-cooperative walk spends on these tests (``"slots"``,
    :func:`any_hit_slots` summed over blocks and chunks), those of a thread
    per ray (``"thread_slots"``: every lane of a block on each chunk some
    ray of it needs), and the slab tests the rays need in that order
    (``"slab_tests"``): chunk c's box for each ray with tlim > 0 that no
    earlier chunk blocked, and half s's box for each such ray that passes
    the chunk's gate and that no earlier half blocked."""
    n, e = o4t.shape[1], mu.shape[1]
    nc = e // BT
    ox, oy, oz, ow = o4t.unbind(0)
    dx, dy, dz, dw = d4t.unbind(0)
    rdx, rdy, rdz = _rcp(dx), _rcp(dy), _rcp(dz)
    occ = torch.zeros(n, dtype=torch.bool, device=o4t.device)
    tests = torch.zeros(n, dtype=torch.float32, device=o4t.device)
    sweeps = torch.zeros_like(tests)

    slots = torch.zeros((), dtype=torch.float32, device=o4t.device)
    slabs = torch.zeros((), dtype=torch.float32, device=o4t.device)
    live = tlim > 0.0
    for c in range(nc):
        tmin, tmax = _slab(bounds[:, c], ox, oy, oz, rdx, rdy, rdz)
        may = live & (tmax >= tmin) & (tmax > 0.0) & (tmin < tlim) & ~occ
        sweeps += _block_any(may)
        before = tests.clone() if counts is not None else None
        if counts is not None:
            slabs += (live & ~occ).sum()
        for s in range(SUB):
            if counts is not None:
                slabs += (live & may & ~occ).sum()
            smin, smax = _slab(sub_bounds[:, c * SUB + s], ox, oy, oz,
                               rdx, rdy, rdz)
            idx = torch.nonzero(may & (smax >= smin) & (smax > 0.0)
                                & (smin < tlim) & ~occ).squeeze(1)
            if idx.numel() == 0:
                continue
            tests[idx] += float(SW)
            lo = c * BT + s * SW
            u, v, t, _, wd_ok = _uvt(
                slice(lo, lo + SW), mu, mv, mw,
                (ox[idx], oy[idx], oz[idx], ow[idx]),
                (dx[idx], dy[idx], dz[idx], dw[idx]))
            blocked = wd_ok & (t > 0.0) & (t < tlim[idx, None]) & \
                (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            occ[idx] = blocked.any(dim=1)
        if counts is not None:
            slots += any_hit_slots(tests - before).sum()
    if counts is not None:
        counts["slots"] = float(slots)
        counts["thread_slots"] = float(sweeps[::BN].sum()) * BN * BT
        counts["slab_tests"] = float(slabs)
    return Occlusion(occ.to(torch.int32), tests, sweeps)


@torch.no_grad()
def occluded(o4t, d4t, tlim, bounds, sub_bounds, mu, mv, mw) -> torch.Tensor:
    """(N,) int32, 1 where something blocks shadow ray ``o4t``/``d4t``
    (4, N) in (0, ``tlim``), over the chunked triangles with inflated chunk
    ``bounds`` (8, nc) and sub-chunk ``sub_bounds`` (8, SUB·nc).

    CUDA tensors launch the kernel (counted in ``occluded.launches``); CPU
    tensors run the plain version. Anything else raises."""
    n, e = _check_inputs(o4t=o4t, d4t=d4t, tlim=tlim, bounds=bounds,
                         sub_bounds=sub_bounds, mu=mu, mv=mv, mw=mw)
    if o4t.device.type == "cpu":
        return occluded_plain(o4t, d4t, tlim, bounds, sub_bounds, mu, mv,
                              mw).occ
    occ = torch.empty(n, dtype=torch.int32, device=o4t.device)
    _launch("occlusion", (o4t, d4t, tlim, bounds, sub_bounds, mu, mv, mw,
                          occ), n, e, wrapper=occluded)
    return occ


occluded.launches = 0


# ---------------------------------------------------------------------------
# Kernel 4: kernels 1 and 2 in one pass
# ---------------------------------------------------------------------------

def closest_hit_rows_nee_plain(o4t, d4t, so4t, sd4t, stmax, bounds,
                               sub_bounds, mu, mv, mw, tab,
                               counts: dict | None = None):
    """Plain version of csrc/closest_hit_rows_nee.cu: the closest-hit rows
    of the bounce rays (rows 0-46 as :func:`closest_hit_rows_plain`) with
    row 47 the chunks on which some unresolved shadow ray of the block
    passes the chunk's gate, and the occlusion of the shadow rays (as
    :func:`occluded_plain`).

    ``counts``, when given, receives what both walks need and spend:
    ``tests``, the ray-triangle tests; ``slab_tests``, every chunk box for
    each bounce ray and the boxes the shadow rays need in index order
    (``occluded_plain``'s count); ``slots``, the thread-slots of the
    block-cooperative walks (:func:`walk_flat_plain`'s and
    ``occluded_plain``'s); ``thread_slots``, those of a thread per ray
    (both functions' counts)."""
    closest = {} if counts is not None else None
    rows = closest_hit_rows_plain(o4t, d4t, bounds, mu, mv, mw, tab,
                                  counts=closest)
    shadow_counts = {} if counts is not None else None
    shadow = occluded_plain(so4t, sd4t, stmax, bounds, sub_bounds, mu, mv,
                            mw, counts=shadow_counts)
    rows[47] = shadow.sweeps
    if counts is not None:
        counts["tests"] = float(rows[45].sum()) + float(shadow.tests.sum())
        counts["slab_tests"] = (o4t.shape[1] * bounds.shape[1]
                                + shadow_counts["slab_tests"])
        for k in ("slots", "thread_slots"):
            counts[k] = closest[k] + shadow_counts[k]
    return rows, shadow.occ


@torch.no_grad()
def closest_hit_rows_nee(o4t, d4t, so4t, sd4t, stmax, bounds, sub_bounds,
                         mu, mv, mw, tab):
    """((48, N) rows, (N,) int32 occlusion) in one pass: the closest hit
    of rays ``o4t``/``d4t`` and the any-hit of shadow rays ``so4t``/
    ``sd4t`` in (0, ``stmax``). Row 46 counts each block's chunk sweeps
    for the first set, row 47 the chunks whose gate some unresolved ray of
    the second set passes.

    CUDA tensors launch the kernel (counted in
    ``closest_hit_rows_nee.launches``); CPU tensors run the plain version.
    Anything else raises."""
    n, e = _check_inputs(o4t=o4t, d4t=d4t, so4t=so4t, sd4t=sd4t,
                         stmax=stmax, bounds=bounds, sub_bounds=sub_bounds,
                         mu=mu, mv=mv, mw=mw, tab=tab)
    if o4t.device.type == "cpu":
        return closest_hit_rows_nee_plain(o4t, d4t, so4t, sd4t, stmax,
                                          bounds, sub_bounds, mu, mv, mw,
                                          tab)
    out = torch.empty((OUT_R, n), dtype=torch.float32, device=o4t.device)
    occ = torch.empty(n, dtype=torch.int32, device=o4t.device)
    _launch("closest_hit_rows_nee", (o4t, d4t, so4t, sd4t, stmax, bounds,
                                     sub_bounds, mu, mv, mw, tab, out, occ),
            n, e, wrapper=closest_hit_rows_nee)
    return out, occ


closest_hit_rows_nee.launches = 0


# ---------------------------------------------------------------------------
# Kernels 3 and 6: the two-level (superchunk) closest hit
# ---------------------------------------------------------------------------

def two_level_slots(may: torch.Tensor) -> torch.Tensor:
    """(N/256,) f32: the thread-slots each 256-ray block spends sweeping
    one staged chunk in csrc/trace_common.cuh ``walk_superchunk_coop`` (and
    in kernel 5's walk, csrc/soft_occlusion.cu), from the rays' gates
    ``may`` (N,) bool. With k needing rays in the nw
    warps that hold one: where 8k > 7·32·nw their own threads sweep all 256
    triangles (nw × 32 lanes × 256), else a warp per ray (⌈k/8⌉ rounds ×
    8 warps × 32 lanes × 8 triangles); 0 where k = 0."""
    m = may.view(-1, WARPS, 32)
    k = m.sum(dim=(1, 2))
    nw = m.any(dim=2).sum(dim=1)
    thread = 8 * k > 7 * 32 * nw
    return torch.where(thread, nw * 32 * BT,
                       (k + WARPS - 1) // WARPS * BN * (BT // 32)
                       ).to(torch.float32)


class TwoLevelWalk(NamedTuple):
    """What :func:`walk_two_level_plain` finds for N rays."""
    walk: _ClosestWalk          # each ray's winner and triangles swept
    sc_entries: torch.Tensor    # (N,) superchunks its block entered
    chunk_sweeps: torch.Tensor  # (N,) chunks its block swept
    slab_tests: torch.Tensor    # (N,) slab tests the ray itself needed:
    #                             every walked superchunk's, and the
    #                             chunks' of each one its own test passed
    slots: torch.Tensor         # (N,) thread-slots its block spent in
    #                             kernels 3 and 6 (:func:`two_level_slots`)
    group_sweeps: torch.Tensor  # (N,) 32-triangle groups kernel 3 sweeps
    #                             for the ray (0 without group boxes)

    @classmethod
    def start(cls, walk: _ClosestWalk) -> "TwoLevelWalk":
        z = torch.zeros_like(walk.best_t)
        return cls(walk, z, z.clone(), z.clone(), z.clone(), z.clone())


def walk_superchunk_plain(acc: TwoLevelWalk, s: int, sel, sc_bounds, bounds,
                          mu, mv, mw, scc, group_bounds=None) -> None:
    """Plain version of csrc/trace_common.cuh ``walk_superchunk_coop``:
    superchunk ``s`` for the rays where ``sel`` (N,) is set (a union of
    whole 256-ray blocks; None: every ray), into ``acc`` in place. A ray
    sweeps a chunk of ``s`` when its own slab tests against the
    superchunk's and the chunk's inflated boxes both pass before its best
    t. With ``group_bounds`` (8, 8·nc), ``acc.group_sweeps`` also counts
    the groups of each such chunk whose own box the ray passes before its
    best t: those kernel 3's group gate sweeps."""
    walk = acc.walk
    sc_may = walk.passes(sc_bounds[:, s])
    acc.slab_tests.add_(1.0 if sel is None else sel.to(torch.float32))
    if sel is not None:
        sc_may &= sel
    if not bool(sc_may.any()):
        return
    acc.sc_entries.add_(_block_any(sc_may))
    acc.slab_tests.add_(scc * sc_may.to(torch.float32))
    for c in range(s * scc, (s + 1) * scc):
        may = sc_may & walk.passes(bounds[:, c])
        acc.chunk_sweeps.add_(_block_any(may))
        acc.slots.add_(two_level_slots(may).repeat_interleave(BN))
        if group_bounds is not None:
            for q in range(c * GROUPS, (c + 1) * GROUPS):
                acc.group_sweeps.add_(may & walk.passes(group_bounds[:, q]))
        walk.sweep(c, may, mu, mv, mw)


def walk_two_level_plain(o4t, d4t, sc_bounds, bounds, mu, mv, mw, scc,
                         group_bounds=None) -> TwoLevelWalk:
    """Plain version of csrc/trace_common.cuh ``walk_two_level``: every
    superchunk in index order (:func:`walk_superchunk_plain`). With
    ``group_bounds``, also each ray's groups swept under kernel 3's group
    gate (``group_sweeps``, 32 ray-triangle tests each; ``steps`` keeps
    the contract's count, 256 a chunk gate)."""
    acc = TwoLevelWalk.start(_ClosestWalk(o4t, d4t))
    for s in range(sc_bounds.shape[1]):
        walk_superchunk_plain(acc, s, None, sc_bounds, bounds, mu, mv, mw,
                              scc, group_bounds)
    return acc


def closest_hit_sc_lite_plain(o4t, d4t, sc_bounds, bounds, group_bounds, mu,
                              mv, mw, scc) -> torch.Tensor:
    """Plain version of csrc/closest_hit_sc_lite.cu: (8, N) rows t, eidx,
    triangles swept by the ray, superchunks its block entered, 4 zeros.
    ``group_bounds`` is accepted and not read: the kernel's group gate
    skips only triangles that cannot win or tie, so the index-order walk
    over whole chunks finds the same rows."""
    walk, sc_entries = walk_two_level_plain(o4t, d4t, sc_bounds, bounds, mu,
                                            mv, mw, scc)[:2]
    out = torch.zeros((LITE_R, o4t.shape[1]), dtype=torch.float32,
                      device=o4t.device)
    out[0], out[1] = walk.best_t, walk.best_e.to(torch.float32)
    out[2], out[3] = walk.steps, sc_entries
    return out


@torch.no_grad()
def closest_hit_sc_lite(o4t, d4t, sc_bounds, bounds, group_bounds, mu, mv,
                        mw, scc) -> torch.Tensor:
    """(8, N) two-level closest hit of rays ``o4t``/``d4t`` (4, N): rows
    0 t (1e9 on a miss), 1 eidx, 2 triangles swept (256 for each chunk
    whose gates the ray passes), 3 superchunks the ray's block entered.
    ``bounds`` (8, nc) are the inflated chunk boxes of ``mu``/``mv``/``mw``
    (4, 256·nc), ``sc_bounds`` (8, nc/scc) those of each ``scc``
    consecutive chunks, ``group_bounds`` (8, 8·nc) those of each chunk's
    32-triangle groups (``TracePrep.group_bounds``), which the kernel
    gates each ray's sweep of a chunk on.

    CUDA tensors launch the kernel (counted in
    ``closest_hit_sc_lite.launches``); CPU tensors run the plain version.
    Anything else raises."""
    n, e = _check_inputs(scc, o4t=o4t, d4t=d4t, sc_bounds=sc_bounds,
                         bounds=bounds, group_bounds=group_bounds, mu=mu,
                         mv=mv, mw=mw)
    if o4t.device.type == "cpu":
        return closest_hit_sc_lite_plain(o4t, d4t, sc_bounds, bounds,
                                         group_bounds, mu, mv, mw, scc)
    out = torch.empty((LITE_R, n), dtype=torch.float32, device=o4t.device)
    _launch("closest_hit_sc_lite", (o4t, d4t, sc_bounds, bounds,
                                    group_bounds, mu, mv, mw, out), n, e, scc,
            wrapper=closest_hit_sc_lite)
    return out


closest_hit_sc_lite.launches = 0


def closest_hit_rows_sc_plain(o4t, d4t, sc_bounds, bounds, mu, mv, mw, tab,
                              scc) -> torch.Tensor:
    """Plain version of csrc/closest_hit_rows_sc.cu: kernel 1's rows for
    the two-level walk, with row 46 the superchunks each block entered and
    row 47 the chunks it swept."""
    walk, sc_entries, chunk_sweeps = walk_two_level_plain(
        o4t, d4t, sc_bounds, bounds, mu, mv, mw, scc)[:3]
    return walk.rows(tab, sc_entries, chunk_sweeps)


@torch.no_grad()
def closest_hit_rows_sc(o4t, d4t, sc_bounds, bounds, mu, mv, mw, tab, scc
                        ) -> torch.Tensor:
    """(48, N) closest-hit rows over the two-level walk of
    :func:`closest_hit_sc_lite`, with the winner table ``tab`` (40, E).

    CUDA tensors launch the kernel (counted in
    ``closest_hit_rows_sc.launches``); CPU tensors run the plain version.
    Anything else raises."""
    n, e = _check_inputs(scc, o4t=o4t, d4t=d4t, sc_bounds=sc_bounds,
                         bounds=bounds, mu=mu, mv=mv, mw=mw, tab=tab)
    if o4t.device.type == "cpu":
        return closest_hit_rows_sc_plain(o4t, d4t, sc_bounds, bounds, mu, mv,
                                         mw, tab, scc)
    out = torch.empty((OUT_R, n), dtype=torch.float32, device=o4t.device)
    _launch("closest_hit_rows_sc", (o4t, d4t, sc_bounds, bounds, mu, mv, mw,
                                    tab, out), n, e, scc,
            wrapper=closest_hit_rows_sc)
    return out


closest_hit_rows_sc.launches = 0


def _sc_lite_fits(prep: TracePrep) -> bool:
    """Kernel 3's envelope: a superchunk scene whose triangle rows fit
    ``_SC_RESIDENT_BYTES``, with ``_SC_LITE`` on."""
    return prep.superchunks and _SC_LITE \
        and prep.m3_bytes <= _SC_RESIDENT_BYTES


# ---------------------------------------------------------------------------
# Kernel 7: one round of regen's frontier march
# ---------------------------------------------------------------------------

BIG_E = (1 << 24) - 1  # the march's "no winner" eidx: exact in f32 and above
#                        every real eidx (E < 2^24)


def march_supported(prep: TracePrep) -> bool:
    """The march's gate (port of ``march_supported``): kernel 3's envelope
    (:func:`_sc_lite_fits`), which the march keeps, as the reference
    does."""
    return _sc_lite_fits(prep)


def march_step_sc_plain(o4t, d4t, init, queue, sc_bounds, bounds, mu, mv,
                        mw, scc, counts: dict | None = None) -> torch.Tensor:
    """Plain version of csrc/march_step_sc.cu: from each ray's carried best
    ``init`` (2, N), each 256-ray block walks its slots of ``queue`` in
    order (:func:`walk_superchunk_plain` per real entry; an entry outside
    [0, nsc) sweeps nothing). (8, N) rows: t, eidx, triangles swept by the
    ray, superchunks its block entered, 4 zeros. ``counts``, when given,
    receives the slab tests the rays needed (``"slab_tests"``), the
    thread-slots of the block-cooperative walk (``"slots"``,
    :func:`two_level_slots`) and of one thread per ray, every lane of a
    block on each chunk it swept (``"thread_slots"``)."""
    n, nsc = o4t.shape[1], sc_bounds.shape[1]
    acc = TwoLevelWalk.start(_ClosestWalk(o4t, d4t, init[0],
                                          init[1].to(torch.int64)))
    q = queue.view(n // BN, -1)
    for j in range(q.shape[1]):
        col = q[:, j].repeat_interleave(BN)  # slot j of each ray's block
        for s in torch.unique(q[:, j]).tolist():
            if 0 <= s < nsc:
                walk_superchunk_plain(acc, s, col == s, sc_bounds, bounds,
                                      mu, mv, mw, scc)
    if counts is not None:
        counts["slab_tests"] = float(acc.slab_tests.sum())
        counts["slots"] = float(acc.slots[::BN].sum())
        counts["thread_slots"] = float(acc.chunk_sweeps[::BN].sum()) * BN * BT
    out = torch.zeros((LITE_R, n), dtype=torch.float32, device=o4t.device)
    out[0], out[1] = acc.walk.best_t, acc.walk.best_e.to(torch.float32)
    out[2], out[3] = acc.walk.steps, acc.sc_entries
    return out


@torch.no_grad()
def march_step_sc(o4t, d4t, init, queue, sc_bounds, bounds, mu, mv, mw, scc
                  ) -> torch.Tensor:
    """(8, N) lite rows of one march round (port of ``_march_step_sc``):
    rays ``o4t``/``d4t`` (4, N) start from their carried best ``init``
    (2, N: t, then eidx as f32; (1e9, ``BIG_E``) for none) and sweep their
    256-ray block's ``queue`` entries (int32, QL per block) with kernel 3's
    superchunk walk; the other operands are kernel 3's.

    CUDA tensors launch the kernel (counted in ``march_step_sc.launches``);
    CPU tensors run the plain version. Anything else raises."""
    n, e = _check_inputs(scc, o4t=o4t, d4t=d4t, init=init, queue=queue,
                         sc_bounds=sc_bounds, bounds=bounds, mu=mu, mv=mv,
                         mw=mw)
    if queue.shape[0] == 0 or queue.shape[0] % (n // BN):
        raise ValueError(f"queue has {queue.shape[0]} entries, not a "
                         f"positive multiple of the {n // BN} blocks")
    if o4t.device.type == "cpu":
        return march_step_sc_plain(o4t, d4t, init, queue, sc_bounds, bounds,
                                   mu, mv, mw, scc)
    out = torch.empty((LITE_R, n), dtype=torch.float32, device=o4t.device)
    _launch("march_step_sc", (o4t, d4t, init, queue, sc_bounds, bounds, mu,
                              mv, mw, out), n, e, scc,
            queue.shape[0] // (n // BN), wrapper=march_step_sc)
    return out


march_step_sc.launches = 0


def march_sweep(prep: TracePrep, ray: Ray, active, b_t, b_e, queue):
    """One march round over a wavefront of N rays, N % 256 == 0 (port of
    ``march_sweep``): parks the dead rays, packs the carried best (``b_t``,
    ``b_e``) and runs :func:`march_step_sc`. Returns (b_t, b_e, triangles
    swept), the last two int64."""
    n = ray.o.x.shape[0]
    if n % BN:
        raise ValueError(f"the march takes whole 256-ray blocks, not {n}")
    o4t, d4t = pack_rays(ray, active)
    init = torch.stack([b_t, b_e.to(torch.float32)])
    out = march_step_sc(o4t, d4t, init, queue, prep.sc_bounds,
                        prep.chunk_bounds, prep.mu_pad, prep.mv_pad,
                        prep.mw_pad, prep.scc)
    return out[0], out[1].to(torch.int64), out[2].to(torch.int64)


@torch.no_grad()
def march_next_candidates(prep: TracePrep, o, d, alive, m_t, m_sc, b_t,
                          k: int = 3):
    """The march's candidate scan (port of ``march_next_candidates``; torch
    ops, no kernel): each ray's next ``k`` unprocessed superchunks, near to
    far. Superchunk s is a candidate for a live ray when its slab test
    against the inflated box passes with slack (tmax + 1e-5·|tmax| + 1e-6
    >= tmin, tmax > -1e-6), its entry max(tmin, 0) is at most the running
    best ``b_t`` and (entry, s) comes after the march cursor (``m_t``,
    ``m_sc``). The reference inserts candidates one superchunk at a time
    into a sorted k-list, an earlier s first on a tie: that is the k
    smallest (entry, s) pairs, which a stable sort of the entries (a
    non-candidate at +inf) gives over all superchunks at once. Returns
    (es, ss): two k-lists of (N,) tensors (f32 entries, int64 superchunk
    ids), s == nsc where there is none."""
    sc = prep.sc_bounds
    nsc = sc.shape[1]

    def col(x):
        return x[:, None]

    # (N, nsc): ray i against superchunk s, with the reference's terms.
    tmin, tmax = _slab(sc, col(o.x), col(o.y), col(o.z), col(_rcp(d.x)),
                       col(_rcp(d.y)), col(_rcp(d.z)))
    slack = 1e-5 * torch.abs(tmax) + 1e-6
    entry = torch.clamp(tmin, min=0.0)
    s_id = torch.arange(nsc, device=sc.device)
    ok = (tmax + slack >= tmin) & (tmax > -1e-6) & col(alive) \
        & (entry <= col(b_t)) \
        & ((entry > col(m_t)) | ((entry == col(m_t)) & (s_id > col(m_sc))))
    key, order = torch.sort(torch.where(ok, entry, torch.inf), dim=1,
                            stable=True)
    es, ss = [], []
    for i in range(k):
        if i < nsc:
            es.append(key[:, i])
            ss.append(torch.where(key[:, i] < torch.inf, order[:, i], nsc))
        else:
            es.append(torch.full_like(b_t, torch.inf))
            ss.append(torch.full_like(order[:, 0], nsc))
    return es, ss


def march_block_queue(ns_cols, nsc: int, ql: int):
    """Each 256-lane block's superchunk queue (port of
    ``march_block_queue``; torch ops, no kernel) from the lanes' candidate
    columns ``ns_cols`` (near to far): the first ``ql`` distinct wanted
    superchunks of the block, filled level by level (every run head of the
    first column, then of the second, ...; a run of equal ids takes one
    slot, a repeat across levels takes another, which the sweep's
    idempotence makes harmless). Returns (queue (N/256 · ql,) int32, with
    ``nsc`` in the slots left empty; (N,) bool, the lanes whose first
    column got a slot). The reference's dropped scatter writes go to one
    sink slot past the end: ranks are distinct within a level and the
    offsets keep the levels apart, so no two kept writes meet."""
    nb = ns_cols[0].shape[0] // BN
    dev = ns_cols[0].device
    base = (torch.arange(nb, device=dev) * ql)[:, None]
    sink = nb * ql
    queue = torch.full((sink + 1,), nsc, dtype=torch.int32, device=dev)
    off = 0
    for i, col in enumerate(ns_cols):
        k = col.reshape(nb, BN)
        head = torch.ones_like(k, dtype=torch.bool)
        head[:, 1:] = k[:, 1:] != k[:, :-1]
        valid = head & (k < nsc)
        rank = torch.cumsum(valid, dim=1) - 1
        slot = off + rank
        idx = torch.where(valid & (slot < ql), base + slot, sink)
        queue[idx.reshape(-1)] = k.reshape(-1).to(torch.int32)
        if i == 0:
            q_ok = (rank >= 0) & (rank < ql) & (k < nsc)
        off = off + valid.sum(dim=1, keepdim=True)
    return queue[:sink], q_ok.reshape(-1)


# ---------------------------------------------------------------------------
# Kernel 5: the top-1 blocker of soft shadow rays
# ---------------------------------------------------------------------------

_NO_BLOCKER = -1e9  # the margin of a shadow ray that found no candidate


class SoftOcclusion(NamedTuple):
    """What :func:`soft_occluded_plain` finds for each of N shadow rays."""
    margin: torch.Tensor  # (N,) f32 the winner's open-edge margin (-1e9:
    #                       no candidate)
    eidx: torch.Tensor    # (N,) i32 its expanded-triangle index (0: none)
    tests: torch.Tensor   # (N,) f32 triangle tests the ray needed: 256 per
    #                       chunk its own slab test passed
    sweeps: torch.Tensor  # (N,) f32 chunks some ray of its 256-ray block
    #                       needed (a thread per ray sweeps each with all
    #                       256 lanes)
    slots: torch.Tensor   # (N,) f32 thread-slots its block spent in the
    #                       block-cooperative walk (:func:`two_level_slots`
    #                       of each chunk's gates, summed)


def soft_bounds(chunk_bounds: torch.Tensor, edge_eps: float) -> torch.Tensor:
    """(8, nc) chunk boxes grown by ``edge_eps`` times their diagonal on
    every side (intersect_pallas.py:1987-1991; not ``_inflate_bounds``): a
    near-miss candidate lies within about ``edge_eps`` of an edge length of
    its triangle, so a ray that narrowly misses the chunk's own box must
    still sweep it, or soft coverage clips to zero at chunk faces."""
    cb = chunk_bounds
    diag = torch.sqrt(torch.clamp(((cb[3:6] - cb[0:3]) ** 2).sum(dim=0),
                                  min=0.0))
    infl = (edge_eps * diag)[None, :]
    return torch.cat([cb[0:3] - infl, cb[3:6] + infl, cb[6:8]],
                     dim=0).contiguous()


def _edge_margins(u, v, ou, ov, ow):
    """(m_open, int_ok) of barycentrics u, v of a plane crossing, with the
    triangle's edge openness masks ``ou``, ``ov``, ``ow`` (the u = 0, v = 0
    and w = 0 edges): the least coordinate over the open edges (1 where
    all are closed), and whether the crossing is inside every closed
    edge."""
    w = 1.0 - u - v
    m_open = torch.minimum(torch.minimum(torch.where(ou, u, 1.0),
                                         torch.where(ov, v, 1.0)),
                           torch.where(ow, w, 1.0))
    int_ok = torch.minimum(torch.minimum(torch.where(ou, 1.0, u),
                                         torch.where(ov, 1.0, v)),
                           torch.where(ow, 1.0, w)) > 0.0
    return m_open, int_ok


def _soft_margins(u, v, t, wd_ok, tmax, eo):
    """(r, k) candidate margins of rays against triangles with openness
    ``eo`` (3, k): ``m_open`` where the ray crosses the triangle's plane in
    (1e-6, tmax) inside every closed edge, else -1e9."""
    m_open, int_ok = _edge_margins(u, v, eo[0] > 0.0, eo[1] > 0.0,
                                   eo[2] > 0.0)
    in_t = wd_ok & (t > 1e-6) & (t < tmax[:, None]) & int_ok
    return torch.where(in_t, m_open, _NO_BLOCKER)


def soft_occluded_plain(o4t, d4t, tmax, bounds, mu, mv, mw, eo
                        ) -> SoftOcclusion:
    """Plain PyTorch version of csrc/soft_occlusion.cu: chunks in index
    order; a ray sweeps a chunk when its own slab test against the chunk's
    (soft-inflated) box passes with tmin < tmax; no early exit, since a
    maximum cannot resolve early. The winner is the largest margin, and
    among equal margins above -1e8 the lowest eidx. Also counts, per ray,
    the chunks its block needed and the thread-slots the kernel's
    block-cooperative walk spends on them: its gate reads no best, so the
    rays a chunk lists are those whose gate passes, as in
    :func:`two_level_slots`."""
    n, e = o4t.shape[1], mu.shape[1]
    o, d = o4t.unbind(0), d4t.unbind(0)
    rd = tuple(_rcp(x) for x in d[:3])
    best_m = torch.full((n,), _NO_BLOCKER, dtype=torch.float32,
                        device=o4t.device)
    best_e = torch.zeros(n, dtype=torch.int64, device=o4t.device)
    tests = torch.zeros_like(best_m)
    sweeps = torch.zeros_like(best_m)
    slots = torch.zeros_like(best_m)
    lane = torch.arange(BT, device=o4t.device)
    for c in range(e // BT):
        tmin, tmx = _slab(bounds[:, c], *o[:3], *rd)
        may = (tmx >= tmin) & (tmx > 0.0) & (tmin < tmax)
        sweeps += _block_any(may)
        slots += two_level_slots(may).repeat_interleave(BN)
        idx = torch.nonzero(may).squeeze(1)
        if idx.numel() == 0:
            continue
        tests[idx] += float(BT)
        cols = slice(c * BT, (c + 1) * BT)
        u, v, t, _, wd_ok = _uvt(cols, mu, mv, mw,
                                 tuple(x[idx] for x in o),
                                 tuple(x[idx] for x in d))
        m = _soft_margins(u, v, t, wd_ok, tmax[idx], eo[:, cols])
        mk = torch.amax(m, dim=1)
        k = torch.where(m == mk[:, None], lane, BT).amin(dim=1)
        mk = m.gather(1, k[:, None])[:, 0]  # the lowest index's own value
        ek = k + c * BT
        cur_m, cur_e = best_m[idx], best_e[idx]
        better = (mk > cur_m) | ((mk == cur_m) & (mk > -1e8) & (ek < cur_e))
        sel = idx[better]
        best_m[sel] = mk[better]
        best_e[sel] = ek[better]
    return SoftOcclusion(best_m, best_e.to(torch.int32), tests, sweeps,
                         slots)


@torch.no_grad()
def soft_occluded(o4t, d4t, tmax, bounds, mu, mv, mw, eo):
    """((N,) f32 margin, (N,) i32 eidx): the top-1 blocker candidate of
    each shadow ray ``o4t``/``d4t`` (4, N) with query (1e-6, ``tmax``),
    over the chunked triangles ``mu``/``mv``/``mw`` (4, E) with
    soft-inflated chunk ``bounds`` (8, E/256, :func:`soft_bounds`) and
    per-triangle edge openness ``eo`` (3, E) (1 = an open, silhouette
    edge). Margin -1e9 and eidx 0 where no triangle qualifies.

    CUDA tensors launch the kernel (counted in ``soft_occluded.launches``);
    CPU tensors run the plain version. Anything else raises."""
    n, e = _check_inputs(o4t=o4t, d4t=d4t, tmax=tmax, bounds=bounds, mu=mu,
                         mv=mv, mw=mw, eo=eo)
    if o4t.device.type == "cpu":
        r = soft_occluded_plain(o4t, d4t, tmax, bounds, mu, mv, mw, eo)
        return r.margin, r.eidx
    margin = torch.empty(n, dtype=torch.float32, device=o4t.device)
    eidx = torch.empty(n, dtype=torch.int32, device=o4t.device)
    _launch("soft_occlusion", (o4t, d4t, tmax, bounds, mu, mv, mw, eo,
                               margin, eidx), n, e, wrapper=soft_occluded)
    return margin, eidx


soft_occluded.launches = 0


# ---------------------------------------------------------------------------
# Kernels 8 and 9: the classic flat closest hit, (t, idx)
# ---------------------------------------------------------------------------

def _classic_plain(o4t, d4t, bounds, mu, mv, mw, block_gate: bool,
                   counts: dict | None = None):
    """The walk of csrc/closest_hit_classic.cu: chunks in index order, each
    ray gated by its slab test against the raw chunk box with a strict
    tmin < its best t; the rays that pass sweep the chunk or, with
    ``block_gate``, every ray of a 256-ray block in which any passes. The
    chunk's lowest t (ties to the lowest index) replaces the best where it
    is strictly lower. Returns (t (N,) f32, idx (N,) int32); ``counts``,
    when given, receives the ray-triangle tests swept (``"tests"``), the
    thread-slots of the kernel's mapping (``"slots"``: kernel 8's
    block-cooperative walk, :func:`two_level_slots` of each chunk's gates;
    kernel 9's block gate, its tests) and those of a thread per ray with
    the block gate of kernel 8's rule (``"thread_slots"``: every lane of
    a block on each chunk some ray of it needs)."""
    n = o4t.shape[1]
    o, d = o4t.unbind(0), d4t.unbind(0)
    rd = tuple(_rcp(x) for x in d[:3])
    best_t = torch.full((n,), _MISS, dtype=torch.float32, device=o4t.device)
    best_i = torch.zeros(n, dtype=torch.int64, device=o4t.device)
    lane = torch.arange(BT, device=o4t.device)
    tests = slots = thread_slots = 0.0
    for c in range(mu.shape[1] // BT):
        tmin, tmax = _slab(bounds[:, c], *o[:3], *rd)
        may = (tmax >= tmin) & (tmax > 0.0) & (tmin < best_t)
        if counts is not None:
            block = _block_any(may)[::BN]
            thread_slots += float(block.sum()) * BN * BT
            slots += float(block.sum()) * BN * BT if block_gate \
                else float(two_level_slots(may).sum())
        if block_gate:
            may = _block_any(may) > 0.0
        idx = torch.nonzero(may).squeeze(1)
        if idx.numel() == 0:
            continue
        tests += idx.numel() * BT
        u, v, t, _, wd_ok = _uvt(slice(c * BT, (c + 1) * BT), mu, mv, mw,
                                 tuple(x[idx] for x in o),
                                 tuple(x[idx] for x in d))
        valid = wd_ok & (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        t = torch.where(valid, t, _MISS)
        tk = torch.amin(t, dim=1)
        k = torch.where(t == tk[:, None], lane, BT).amin(dim=1)
        better = tk < best_t[idx]
        sel = idx[better]
        best_t[sel] = tk[better]
        best_i[sel] = k[better] + c * BT
    if counts is not None:
        counts.update(tests=float(tests), slots=slots,
                      thread_slots=thread_slots)
    return best_t, best_i.to(torch.int32)


def closest_hit_classic_plain(o4t, d4t, bounds, mu, mv, mw, counts=None):
    """Plain version of csrc/closest_hit_classic.cu ``closest_hit_classic``
    (kernel 8): only the rays whose own gate passes sweep a chunk (the
    kernel lists them and sweeps each with a warp, or with their own
    threads where the needing warps are nearly full)."""
    return _classic_plain(o4t, d4t, bounds, mu, mv, mw, False, counts)


def closest_hit_loop_plain(o4t, d4t, bounds, mu, mv, mw, counts=None):
    """Plain version of csrc/closest_hit_classic.cu ``closest_hit_loop``
    (kernel 9): every ray of a 256-ray block sweeps a chunk once any ray of
    the block passes its gate, so the answer depends on the packing."""
    return _classic_plain(o4t, d4t, bounds, mu, mv, mw, True, counts)


def _classic(wrapper, plain, o4t, d4t, bounds, mu, mv, mw):
    """Kernel 8 or 9 (``wrapper``, whose name is its entry point in
    csrc/closest_hit_classic.cu) on CUDA tensors, ``plain`` on CPU ones."""
    n, e = _check_inputs(o4t=o4t, d4t=d4t, bounds=bounds, mu=mu, mv=mv,
                         mw=mw)
    if o4t.device.type == "cpu":
        return plain(o4t, d4t, bounds, mu, mv, mw)
    t = torch.empty(n, dtype=torch.float32, device=o4t.device)
    idx = torch.empty(n, dtype=torch.int32, device=o4t.device)
    _launch(wrapper.__name__, (o4t, d4t, bounds, mu, mv, mw, t, idx), n, e,
            source="closest_hit_classic", wrapper=wrapper)
    return t, idx


@torch.no_grad()
def closest_hit_classic(o4t, d4t, bounds, mu, mv, mw):
    """((N,) f32 t, (N,) int32 idx): the closest hit of rays ``o4t``/
    ``d4t`` (4, N) over the chunked triangles ``mu``/``mv``/``mw`` (4, E)
    with the RAW chunk ``bounds`` (8, E/256) (port of ``_closest_hit``,
    kernel 8): a ray sweeps a chunk when its own slab test passes with
    tmin < its best t. t 1e9 and idx 0 on a miss.

    CUDA tensors launch the kernel (counted in
    ``closest_hit_classic.launches``); CPU tensors run the plain version.
    Anything else raises."""
    return _classic(closest_hit_classic, closest_hit_classic_plain, o4t,
                    d4t, bounds, mu, mv, mw)


closest_hit_classic.launches = 0


@torch.no_grad()
def closest_hit_loop(o4t, d4t, bounds, mu, mv, mw):
    """The contract of :func:`closest_hit_classic` with kernel 9's block
    gate (port of ``_closest_hit_loop``): every ray of a 256-ray block
    sweeps a chunk once any ray of it passes its gate.

    CUDA tensors launch the kernel (counted in
    ``closest_hit_loop.launches``); CPU tensors run the plain version.
    Anything else raises."""
    return _classic(closest_hit_loop, closest_hit_loop_plain, o4t, d4t,
                    bounds, mu, mv, mw)


closest_hit_loop.launches = 0


# ---------------------------------------------------------------------------
# Wavefront wrappers
# ---------------------------------------------------------------------------

_FAR, _S3 = 1e9, 0.5773503  # parking spot and direction of a dead ray


def pack_rays(ray: Ray, active=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(o4t, d4t), each (4, N padded to a multiple of 256): rays as (o, 1)
    and (d, 0). Dead rays (``active`` False) and the padding are parked far
    outside the scene pointing away, so every chunk slab test fails and
    they sweep nothing."""
    n = ray.o.x.shape[0]
    n_pad = -(-n // BN) * BN
    ox, oy, oz = ray.o.x, ray.o.y, ray.o.z
    dx, dy, dz = ray.d.x, ray.d.y, ray.d.z
    if active is not None:
        ox = torch.where(active, ox, _FAR)
        oy = torch.where(active, oy, _FAR)
        oz = torch.where(active, oz, _FAR)
        dx = torch.where(active, dx, _S3)
        dy = torch.where(active, dy, _S3)
        dz = torch.where(active, dz, _S3)

    def pad(x, value=0.0):
        return torch.nn.functional.pad(x, (0, n_pad - n), value=value)

    o4t = torch.stack([pad(ox, _FAR), pad(oy, _FAR), pad(oz, _FAR),
                       pad(torch.ones_like(ox))])
    d4t = torch.stack([pad(dx, 1.0), pad(dy, 1.0), pad(dz, 1.0),
                       pad(torch.zeros_like(dx))])
    return o4t, d4t


def pack_shadow_rays(ray: Ray, active, tlim):
    """(o4t, d4t, tlim) of shadow rays: :func:`pack_rays` plus the (N
    padded,) query limits, 0 for dead rays and the padding."""
    o4t, d4t = pack_rays(ray, active)
    if active is not None:
        tlim = torch.where(active, tlim, 0.0)
    return o4t, d4t, torch.nn.functional.pad(
        tlim, (0, o4t.shape[1] - tlim.shape[0])).contiguous()


def _hit_from_rows(rows: torch.Tensor, active) -> HitInfo:
    t = rows[40]
    if active is not None:
        t = torch.where(active, t, MISS_T)
    return HitInfo(t=t,
                   tri=rows[15].to(torch.int32),
                   inst=rows[16].to(torch.int32),
                   u=torch.clamp(rows[41], 0.0, 1.0),
                   v=torch.clamp(rows[42], 0.0, 1.0),
                   front=rows[43] < 0.0,
                   steps=rows[45].to(torch.int32),
                   eidx=rows[44].to(torch.int32),
                   rows=rows)


def lite_epilogue(scene: Scene, prep: TracePrep, ray: Ray, active, t,
                  eidx) -> HitInfo:
    """HitInfo of the winners (t, eidx) of the lite kernel (port of
    ``lite_epilogue``): u, v and w_d from one (N, 12) ``isect_cols`` row
    per ray and 4-term dots, tri and inst from one (N, 2) ``tri_inst`` row.
    ``rows`` is None, so shading gathers (render/shading.py
    ``get_shading_data_fast``). Runs in the span ``trace_epilogue``."""
    with SPANS.trace_epilogue:
        hit = t < MISS_T
        eidx = torch.where(hit, eidx, 0)
        rows12 = scene.isect_cols[eidx]

        def dot4(c0, x, y, z, w):
            return rows12[:, c0] * x + rows12[:, c0 + 1] * y + \
                rows12[:, c0 + 2] * z + rows12[:, c0 + 3] * w

        (ox, oy, oz), (dx, dy, dz) = ray.o, ray.d
        one, zero = torch.ones_like(ox), torch.zeros_like(ox)
        u = dot4(0, ox, oy, oz, one) + t * dot4(0, dx, dy, dz, zero)
        v = dot4(4, ox, oy, oz, one) + t * dot4(4, dx, dy, dz, zero)
        w_d = dot4(8, dx, dy, dz, zero)
        ti = prep.tri_inst[eidx]
        if active is not None:
            t = torch.where(active, t, MISS_T)
        return HitInfo(t=t, tri=torch.where(hit, ti[:, 0], 0),
                       inst=torch.where(hit, ti[:, 1], 0),
                       u=torch.clamp(u, 0.0, 1.0),
                       v=torch.clamp(v, 0.0, 1.0),
                       front=w_d < 0.0, steps=torch.zeros_like(eidx),
                       eidx=eidx)


def sc_lite_winners(ray: Ray, active, prep: TracePrep) -> torch.Tensor:
    """Kernel 3's raw winners of a wavefront on a scene that
    :func:`_sc_lite_fits`: (8, n) rows 0 t (MISS_T on a miss and where
    ``active`` is False), 1 eidx, 2 triangles swept, 3 superchunks entered
    (:func:`closest_hit_sc_lite`), the first n columns of the padded
    output. No epilogue: :func:`trace_pallas` adds :func:`lite_epilogue`,
    regen's shading kernel (ops/shade.py ``regen_shade_lite``) reads them
    as they are."""
    o4t, d4t = pack_rays(ray, active)
    return closest_hit_sc_lite(o4t, d4t, prep.sc_bounds, prep.chunk_bounds,
                               prep.group_bounds, prep.mu_pad, prep.mv_pad,
                               prep.mw_pad, prep.scc)[:, :ray.o.x.shape[0]]


def trace_pallas(scene: Scene, ray: Ray, active=None,
                 prep: TracePrep | None = None) -> HitInfo:
    """Closest hit for a wavefront (port of ``trace_pallas``): parks dead
    rays, pads to a multiple of 256 and dispatches by the reference's rule:
    a flat scene to :func:`closest_hit_rows`; a superchunk scene to
    :func:`closest_hit_sc_lite` and :func:`lite_epilogue` while its
    triangle rows fit ``_SC_RESIDENT_BYTES`` (and ``_SC_LITE``), else to
    :func:`closest_hit_rows_sc`. A rows kernel's HitInfo carries ``rows``
    for render/shading.py ``shading_from_rows``."""
    if prep is None:
        prep = prepare_trace_inputs(scene)
    if _sc_lite_fits(prep):
        lite = sc_lite_winners(ray, active, prep)
        return lite_epilogue(scene, prep, ray, active, lite[0],
                             lite[1].to(torch.int32))._replace(
            steps=lite[2].to(torch.int32))
    n = ray.o.x.shape[0]
    o4t, d4t = pack_rays(ray, active)
    if prep.superchunks:
        rows = closest_hit_rows_sc(o4t, d4t, prep.sc_bounds,
                                   prep.chunk_bounds, prep.mu_pad,
                                   prep.mv_pad, prep.mw_pad, prep.tab,
                                   prep.scc)[:, :n]
    else:
        rows = closest_hit_rows(o4t, d4t, prep.bounds, prep.mu, prep.mv,
                                prep.mw, prep.tab)[:, :n]
    return _hit_from_rows(rows, active)


def trace_pallas_classic(scene: Scene, ray: Ray, active=None,
                         prep: TracePrep | None = None) -> HitInfo:
    """Closest hit for a wavefront through kernel 8 (port of
    ``trace_pallas_classic``, the reference's original wrapper, which no
    frame loop calls): parks dead rays, pads to a multiple of 256, runs
    :func:`closest_hit_classic` over the raw chunk boxes and takes u, v and
    front from the winner's ``isect_cols`` row (:func:`lite_epilogue`).
    ``steps`` is E on every ray."""
    n = ray.o.x.shape[0]
    if prep is None:
        prep = prepare_trace_inputs(scene)
    o4t, d4t = pack_rays(ray.detach(), active)
    t, idx = closest_hit_classic(
        o4t, d4t, scene.isect_chunk_bounds.detach().contiguous(), prep.mu,
        prep.mv, prep.mw)
    hit = lite_epilogue(scene, prep, ray, active, t[:n], idx[:n])
    return hit._replace(steps=torch.full_like(hit.eidx, prep.mu.shape[1]))


def occluded_pallas(scene: Scene, ray: Ray, t_max, active=None,
                    prep: TracePrep | None = None) -> torch.Tensor:
    """Any-hit query (port of ``occluded_pallas``): (N,) bool, True where
    something blocks ``ray`` in (0, ``t_max``); False for inactive rays.
    Every scene, superchunk scenes too, takes the flat occlusion kernel
    over its unpadded chunks, as the reference does."""
    n = ray.o.x.shape[0]
    o4t, d4t, tlim = pack_shadow_rays(ray, active, t_max)
    if prep is None:
        prep = prepare_trace_inputs(scene)
    occ = occluded(o4t, d4t, tlim, prep.bounds, prep.sub_bounds, prep.mu,
                   prep.mv, prep.mw)[:n] != 0
    return occ if active is None else occ & active


def trace_occlude_pallas(scene: Scene, ray: Ray, active, sh_ray: Ray,
                         sh_tmax, sh_active, prep: TracePrep | None = None):
    """Closest hit for ``ray`` and any-hit occlusion for ``sh_ray`` in one
    :func:`closest_hit_rows_nee` launch (port of ``trace_occlude_pallas``).
    Returns (HitInfo with rows, (N,) bool occluded & ``sh_active``).
    Flat scenes only: neither frame loop fuses NEE on a superchunk scene."""
    if prep is None:
        prep = prepare_trace_inputs(scene)
    if prep.superchunks:
        raise ValueError("trace_occlude_pallas takes flat scenes only (at "
                         f"most {MAX_FLAT_CHUNKS} chunks)")
    n = ray.o.x.shape[0]
    o4t, d4t = pack_rays(ray, active)
    so4t, sd4t, stmax = pack_shadow_rays(sh_ray, sh_active, sh_tmax)
    rows, occ = closest_hit_rows_nee(o4t, d4t, so4t, sd4t, stmax,
                                     prep.bounds, prep.sub_bounds, prep.mu,
                                     prep.mv, prep.mw, prep.tab)
    return _hit_from_rows(rows[:, :n], active), (occ[:n] != 0) & sh_active


# ---------------------------------------------------------------------------
# Differentiable forms: a kernel finds, torch recomputes
# ---------------------------------------------------------------------------

def _winner_uvt(rows12, ray: Ray):
    """(t, u, v, w_d) of ``ray`` against its winner's (N, 12) ``isect_cols``
    rows, with 4-term dots (the reference's recompute epilogue); where
    |w_d| <= 1e-12 it divides by +-1e-12 instead."""
    def dot4(c0, x, y, z, w):
        return rows12[:, c0] * x + rows12[:, c0 + 1] * y + \
            rows12[:, c0 + 2] * z + rows12[:, c0 + 3] * w

    (ox, oy, oz), (dx, dy, dz) = ray.o, ray.d
    one, zero = torch.ones_like(ox), torch.zeros_like(ox)
    w_o = dot4(8, ox, oy, oz, one)
    w_d = dot4(8, dx, dy, dz, zero)
    inv_wd = torch.where(torch.abs(w_d) > _WD_EPS, w_d,
                         torch.where(w_d < 0, -_WD_EPS, _WD_EPS))
    t = -w_o / inv_wd
    u = dot4(0, ox, oy, oz, one) + t * dot4(0, dx, dy, dz, zero)
    v = dot4(4, ox, oy, oz, one) + t * dot4(4, dx, dy, dz, zero)
    return t, u, v, w_d


def _diff_epilogue(scene: Scene, ray: Ray, hit0: HitInfo) -> HitInfo:
    """Differentiable recompute of t, u and v of the winner ``hit0.eidx``
    from the live ``scene.isect_cols`` (port of ``_diff_epilogue``): one
    (N, 12) gather and 4-term dots, through which autograd reaches the
    triangle tables (so vertices and instance transforms) and the ray (so
    the camera). ``rows`` is None, so shading gathers from the live
    material and texture tables. MISS_T where ``hit0`` missed. Runs in the
    span ``trace_recompute``."""
    with SPANS.trace_recompute:
        rows12 = scene.isect_cols.index_select(0, hit0.eidx)
        t, u, v, _ = _winner_uvt(rows12, ray)
        t = torch.where(hit0.t < MISS_T, t, MISS_T)
        return HitInfo(t=t, tri=hit0.tri, inst=hit0.inst,
                       u=torch.clamp(u, 0.0, 1.0),
                       v=torch.clamp(v, 0.0, 1.0), front=hit0.front,
                       steps=hit0.steps, eidx=hit0.eidx)


def trace_pallas_diff(scene: Scene, ray: Ray, active=None,
                      prep: TracePrep | None = None) -> HitInfo:
    """Differentiable closest hit (port of ``trace_pallas_diff``):
    :func:`trace_pallas` on the detached scene and rays finds each winner,
    :func:`_diff_epilogue` recomputes its hit record from the live ones.
    The primal values are trace_pallas's up to the recompute's rounding."""
    hit0 = trace_pallas(scene.detach(), ray.detach(), active, prep)
    return _diff_epilogue(scene, ray, hit0)


def trace_occlude_pallas_diff(scene: Scene, ray: Ray, active, sh_ray: Ray,
                              sh_tmax, sh_active,
                              prep: TracePrep | None = None):
    """Differentiable form of :func:`trace_occlude_pallas` (port of
    ``trace_occlude_pallas_diff``): kernel 4 finds on detached inputs, the
    closest hit is recomputed by :func:`_diff_epilogue`; hard shadow
    visibility has no derivative almost everywhere and stays a bool."""
    hit0, occ = trace_occlude_pallas(scene.detach(), ray.detach(), active,
                                     sh_ray.detach(), sh_tmax.detach(),
                                     sh_active, prep)
    return _diff_epilogue(scene, ray, hit0), occ


def soft_occluded_pallas(scene: Scene, ray: Ray, t_max, active=None,
                         edge_eps: float = 2e-2,
                         prep: TracePrep | None = None) -> torch.Tensor:
    """Differentiable soft visibility in [0, 1] of shadow rays (port of
    ``soft_occluded_pallas``): :func:`soft_occluded` (kernel 5, on detached
    inputs, over the unpadded chunks of any scene) finds each ray's
    candidate blocker with the largest open-edge margin; its coverage
    ``sigmoid(margin / edge_eps)`` is recomputed from the live
    ``scene.isect_cols`` row, so gradients reach blocker vertices and
    instance poses. The openness gates and the range test are detached.
    1 for inactive rays and where no candidate was found."""
    if prep is None:
        prep = prepare_trace_inputs(scene)
    n = ray.o.x.shape[0]
    o4t, d4t, tlim = pack_shadow_rays(ray.detach(), active, t_max.detach())
    eo_n = scene.tri_edge_open.detach()[scene.isect_tri.long()]  # (E, 3)
    marg0, eidx = soft_occluded(
        o4t, d4t, tlim,
        soft_bounds(scene.isect_chunk_bounds.detach(), edge_eps),
        prep.mu, prep.mv, prep.mw, eo_n.T.contiguous())
    found = marg0[:n] > -1e8
    eidx = eidx[:n].long()

    t, u, v, w_d = _winner_uvt(scene.isect_cols.index_select(0, eidx), ray)
    eo_w = eo_n[eidx] > 0.0  # (N, 3), detached like the kernel's gates
    m_open, int_ok = _edge_margins(u, v, eo_w[:, 0], eo_w[:, 1], eo_w[:, 2])
    in_t = ((torch.abs(w_d) > _WD_EPS) & (t > 1e-6) & (t < t_max)
            & int_ok).detach()
    cov = torch.where(found & in_t, torch.sigmoid(m_open / edge_eps), 0.0)
    vis = 1.0 - cov
    return vis if active is None else torch.where(active, vis, 1.0)
