"""Two-level (TLAS → BLAS) BVH traversal — port of ``trace_bvh`` of
gdpathtracing_tpu/render/traverse.py, the ``Traversal.BVH`` backend (the
default ``RenderConfig()``'s).

The contract, the reference's:

- a stack entry is ``(inst + 1) << NODE_BITS | node`` in 32 bits: tag 0 is
  a TLAS node, tag k a BLAS node of instance k - 1; the root is TLAS node 0;
- popping a TLAS leaf pushes its instance's BLAS root; popping an inner
  node pushes the children whose box (``intersect_aabb``: world space for
  the TLAS, the instance's object space for a BLAS) is entered before the
  best t so far (``dl < best.t``, strict), the far child first and the
  near one (``dl < dr``: on a tie the right child is near) on top;
- popping a BLAS leaf tests its up to 4 triangles with
  ``moller_trumbore`` in object space, bounded by the best t so far
  (directions are not renormalised, so t compares across instances);
  ``steps`` counts these tests;
- a push at ``ptr >= max_stack`` is dropped but ``ptr`` still rises, and a
  pop at ``ptr - 1 >= max_stack`` reads entry ``max_stack - 1`` (the
  reference's clamped gather); every index into the scene's tables is
  clamped likewise;
- a ray pops at most ``max_iters`` entries (the reference caps its
  lockstep loop's iterations, and every live ray pops once an iteration);
- ``t`` is MISS_T where a ray is not active; ``eidx`` is -1 (no expanded
  triangle index: shading gathers by ``tri`` and ``inst``).

:func:`trace_bvh` dispatches: CUDA tensors launch the kernel
(csrc/trace_bvh.cu, one thread per ray with its own stack, built by nvcc
at first use, counted in ``trace_bvh.launches``), CPU tensors run
:func:`trace_bvh_plain`, a lockstep loop over the live rays like the
reference's, which the CPU tests hold against JAX and chip_smoke.py holds
against the kernel on the card, bit for bit; anything else raises. The
traversal finds hits; it is not differentiated (a differentiable render
refuses it, render/integrator.py).
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.core.math3d import (affine_apply_dir,
                                             affine_apply_point)
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.render.intersect import (intersect_aabb,
                                                  moller_trumbore)
from gdpathtracing_torch.render.types import MISS_T, HitInfo, Ray
from gdpathtracing_torch.scene.scene import Scene
from gdpathtracing_torch.utils.telemetry import launched

NODE_BITS = 21
NODE_MASK = (1 << NODE_BITS) - 1
MAX_LEAF = 4
LOCAL_STACK = 64  # the kernel keeps deeper stacks in device memory
_U32 = 0xFFFFFFFF  # entries are uint32, as the reference's


def _check_args(max_stack: int, max_iters: int) -> None:
    if not isinstance(max_stack, int) or max_stack < 1:
        raise ValueError(f"max_stack={max_stack!r} must be a positive int")
    if not isinstance(max_iters, int) or not 0 <= max_iters < 2 ** 31:
        raise ValueError(f"max_iters={max_iters!r} must be an int in "
                         f"[0, 2^31)")


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with idx clamped into range (the reference's gather)."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1)]


def _vec(table: torch.Tensor, idx: torch.Tensor) -> Vec3:
    return Vec3.from_array(_gather(table, idx))


def trace_bvh_plain(scene: Scene, ray: Ray, active=None, max_stack: int = 64,
                    max_iters: int = 1 << 20,
                    counts: dict | None = None) -> HitInfo:
    """Plain PyTorch version of the traversal (the module's contract): the
    reference's lockstep loop, each iteration over the rays whose stack is
    not empty. ``counts``, when given, receives the entries popped
    (``"pops"``), the inner nodes among them (``"inner"``: two box tests
    each), the BLAS entries (``"blas"``: an object-space ray each) and the
    triangle tests (``"tri_tests"``)."""
    _check_args(max_stack, max_iters)
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    rcp_w = ray.rcp_d()
    stack = torch.zeros((n, max_stack), dtype=torch.int64, device=dev)
    ptr = torch.ones(n, dtype=torch.int64, device=dev) if active is None \
        else active.to(torch.int64)
    best = HitInfo.none_like(ray.o.x)
    t_b, tri_b, inst_b = best.t.clone(), best.tri.clone(), best.inst.clone()
    u_b, v_b, front_b = best.u.clone(), best.v.clone(), best.front.clone()
    steps_b = best.steps.clone()
    pops = inner_n = blas_n = 0
    it = 0
    while it < max_iters:
        rows = torch.nonzero(ptr > 0).squeeze(1)
        if rows.numel() == 0:
            break
        it += 1
        p = ptr[rows]
        entry = stack[rows, torch.clamp(p - 1, max=max_stack - 1)]
        p = p - 1
        o = Vec3(ray.o.x[rows], ray.o.y[rows], ray.o.z[rows])
        d = Vec3(ray.d.x[rows], ray.d.y[rows], ray.d.z[rows])
        rw = Vec3(rcp_w.x[rows], rcp_w.y[rows], rcp_w.z[rows])
        bt = t_b[rows]

        tag = entry >> NODE_BITS
        node = entry & NODE_MASK
        is_tlas = tag == 0
        inst = torch.clamp(tag - 1, min=0)

        # TLAS side: children's slab tests in world space; a leaf pushes
        # its instance's BLAS root.
        t_left = _gather(scene.tlas_left, node).to(torch.int64)
        t_right = _gather(scene.tlas_right, node).to(torch.int64)
        tlas_leaf = is_tlas & (t_left == 0)
        tlas_inner = is_tlas & (t_left != 0)
        t_dl = intersect_aabb(o, rw, _vec(scene.tlas_min, t_left),
                              _vec(scene.tlas_max, t_left))
        t_dr = intersect_aabb(o, rw, _vec(scene.tlas_min, t_right),
                              _vec(scene.tlas_max, t_right))
        leaf_inst = _gather(scene.tlas_inst, node).to(torch.int64)
        root_entry = (((leaf_inst + 1) << NODE_BITS)
                      | _gather(scene.inst_root, leaf_inst).to(torch.int64)
                      ) & _U32

        # BLAS side: the ray in the instance's object space.
        inv = _gather(scene.inst_inv_transform, inst)  # (r, 3, 4)
        o_obj = affine_apply_point(inv, o)
        d_obj = affine_apply_dir(inv, d)
        rcp_o = Ray(o_obj, d_obj).rcp_d()
        b_left = _gather(scene.node_left, node).to(torch.int64)
        b_right = _gather(scene.node_right, node).to(torch.int64)
        b_first = _gather(scene.node_first, node).to(torch.int64)
        b_count = _gather(scene.node_count, node).to(torch.int64)
        blas_leaf = ~is_tlas & (b_count > 0)
        blas_inner = ~is_tlas & (b_count == 0)
        b_dl = intersect_aabb(o_obj, rcp_o, _vec(scene.node_min, b_left),
                              _vec(scene.node_max, b_left))
        b_dr = intersect_aabb(o_obj, rcp_o, _vec(scene.node_min, b_right),
                              _vec(scene.node_max, b_right))

        # Leaf: up to 4 triangles, each bounded by the best so far.
        r_obj = Ray(o_obj, d_obj)
        tri_r, inst_r = tri_b[rows], inst_b[rows]
        u_r, v_r, front_r = u_b[rows], v_b[rows], front_b[rows]
        steps_r = steps_b[rows]
        for k in range(MAX_LEAF):
            tri_idx = b_first + k
            tri_live = blas_leaf & (k < b_count)
            tv = _gather(scene.tri_pos, tri_idx)  # (r, 3, 3)
            ok, t, u, v, front = moller_trumbore(
                r_obj, Vec3.from_array(tv[:, 0]), Vec3.from_array(tv[:, 1]),
                Vec3.from_array(tv[:, 2]), bt)
            upd = tri_live & ok
            bt = torch.where(upd, t, bt)
            tri_r = torch.where(upd, tri_idx.to(torch.int32), tri_r)
            inst_r = torch.where(upd, inst.to(torch.int32), inst_r)
            u_r = torch.where(upd, u, u_r)
            v_r = torch.where(upd, v, v_r)
            front_r = torch.where(upd, front, front_r)
            steps_r = steps_r + tri_live.to(torch.int32)

        # Ordered pushes: far first, near on top.
        inner = tlas_inner | blas_inner
        dl = torch.where(is_tlas, t_dl, b_dl)
        dr = torch.where(is_tlas, t_dr, b_dr)
        left_entry = torch.where(is_tlas, t_left,
                                 ((tag << NODE_BITS) | b_left) & _U32)
        right_entry = torch.where(is_tlas, t_right,
                                  ((tag << NODE_BITS) | b_right) & _U32)
        left_ok = inner & (dl < bt)
        right_ok = inner & (dr < bt)
        left_near = dl < dr
        near_entry = torch.where(left_near, left_entry, right_entry)
        far_entry = torch.where(left_near, right_entry, left_entry)
        near_ok = torch.where(left_near, left_ok, right_ok)
        far_ok = torch.where(left_near, right_ok, left_ok)
        near_entry = torch.where(tlas_leaf, root_entry, near_entry)
        near_ok = near_ok | tlas_leaf
        for ok_, entry_ in ((far_ok, far_entry), (near_ok, near_entry)):
            put = ok_ & (p < max_stack)
            stack[rows[put], p[put]] = entry_[put]
            p = p + ok_.to(torch.int64)

        ptr[rows] = p
        t_b[rows], tri_b[rows], inst_b[rows] = bt, tri_r, inst_r
        u_b[rows], v_b[rows], front_b[rows] = u_r, v_r, front_r
        steps_b[rows] = steps_r
        if counts is not None:
            pops += rows.numel()
            inner_n += int(inner.sum())
            blas_n += int((~is_tlas).sum())
    if counts is not None:
        counts.update(pops=float(pops), inner=float(inner_n),
                      blas=float(blas_n), tri_tests=float(steps_b.sum()))
    if active is not None:
        t_b = torch.where(active, t_b, MISS_T)
    return HitInfo(t=t_b, tri=tri_b, inst=inst_b, u=u_b, v=v_b,
                   front=front_b, steps=steps_b, eidx=best.eidx)


# The scene tables the kernel reads, in the order of its C entry point,
# with their dtype and shape (T triangles, B BLAS nodes, L TLAS nodes, I
# instances).
_F32, _I32 = torch.float32, torch.int32
_TABLES = {"tri_pos": (_F32, ("T", 3, 3)), "node_min": (_F32, ("B", 3)),
           "node_max": (_F32, ("B", 3)), "node_left": (_I32, ("B",)),
           "node_right": (_I32, ("B",)), "node_first": (_I32, ("B",)),
           "node_count": (_I32, ("B",)), "tlas_min": (_F32, ("L", 3)),
           "tlas_max": (_F32, ("L", 3)), "tlas_left": (_I32, ("L",)),
           "tlas_right": (_I32, ("L",)), "tlas_inst": (_I32, ("L",)),
           "inst_inv_transform": (_F32, ("I", 3, 4)),
           "inst_root": (_I32, ("I",))}


def _launch_kernel(scene: Scene, ray: Ray, active, max_stack: int,
                   max_iters: int) -> HitInfo:
    from gdpathtracing_torch.ops.intersect import _c_function

    dev = ray.o.x.device
    n = ray.o.x.shape[0]
    rays = torch.stack([ray.o.x, ray.o.y, ray.o.z, ray.d.x, ray.d.y,
                        ray.d.z]).to(torch.float32).contiguous()
    act = (torch.ones(n, dtype=torch.uint8, device=dev) if active is None
           else active.to(torch.uint8).contiguous())
    sizes = dict(T=scene.tri_pos.shape[0], B=scene.node_min.shape[0],
                 L=scene.tlas_min.shape[0], I=scene.inst_root.shape[0])
    tables = []
    for name, (dtype, shape) in _TABLES.items():
        x = getattr(scene, name).detach()
        want = tuple(sizes.get(k, k) for k in shape)
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != want:
            raise ValueError(f"scene.{name} is {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}; the kernel takes {dtype} {want} "
                             f"on {dev}")
        tables.append(x.contiguous())
    scratch = torch.empty((max_stack if max_stack > LOCAL_STACK else 1, n),
                          dtype=torch.int32, device=dev)
    out_f = torch.empty((3, n), dtype=torch.float32, device=dev)
    out_i = torch.empty((4, n), dtype=torch.int32, device=dev)
    fn = _c_function("trace_bvh", 2 + len(_TABLES) + 3, 7)
    with torch.cuda.device(dev):
        args = (rays.data_ptr(), act.data_ptr(),
                *(x.data_ptr() for x in tables), scratch.data_ptr(),
                out_f.data_ptr(), out_i.data_ptr(), n,
                *sizes.values(), max_stack, max_iters,
                torch.cuda.current_stream(dev).cuda_stream)
        launched(trace_bvh, "trace_bvh_kernel")
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"trace_bvh kernel launch failed: cudaError {err}")
    t = out_f[0] if active is None else torch.where(active, out_f[0], MISS_T)
    return HitInfo(t=t, tri=out_i[0], inst=out_i[1], u=out_f[1], v=out_f[2],
                   front=out_i[2] != 0, steps=out_i[3],
                   eidx=torch.full_like(out_i[0], -1))


@torch.no_grad()
def trace_bvh(scene: Scene, ray: Ray, active=None, max_stack: int = 64,
              max_iters: int = 1 << 20) -> HitInfo:
    """Closest hit for the wavefront ``ray`` ((N,) components) by the
    two-level BVH (the module's contract), ``active`` (N,) bool or None.

    CUDA tensors launch the kernel (counted in ``trace_bvh.launches``); CPU
    tensors run :func:`trace_bvh_plain`. Anything else raises. Either way
    ``trace_bvh.lanes`` rises by N, the lanes handed over, live or not (a
    host integer: nothing is read from the device)."""
    _check_args(max_stack, max_iters)
    dev = ray.o.x.device
    if scene.device != dev:
        raise ValueError(f"the scene is on {scene.device}, the rays on {dev}")
    if active is not None and (active.shape != ray.o.x.shape
                               or active.device != dev):
        raise ValueError(f"active is {tuple(active.shape)} on "
                         f"{active.device}, the rays "
                         f"{tuple(ray.o.x.shape)} on {dev}")
    ray = ray.detach()
    trace_bvh.lanes += ray.o.x.shape[0]
    if dev.type == "cpu":
        return trace_bvh_plain(scene, ray, active, max_stack, max_iters)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return _launch_kernel(scene, ray, active, max_stack, max_iters)


trace_bvh.launches = 0
trace_bvh.lanes = 0
