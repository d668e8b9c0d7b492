"""Dynamic scenes: moving instances and deforming meshes, in the graph.

Port of gdpathtracing_tpu/scene/dynamic.py. ``update_instance_transforms``
rebuilds, from new instance affines and with ordinary torch ops, every
table the PALLAS path reads: the instance inverses, the expanded
world-space triangles and their unit-space columns (``isect_mu/mv/mw``,
``isect_cols``), the Morton re-sort, the chunk boxes, the shade rows and a
refit TLAS. ``refit_blas`` refits the BLAS boxes after ``tri_pos`` moved;
``update_vertices`` does both. Autograd flows from the tables back to the
transforms and vertices, which is what geometry gradients through the
differentiable path need (render/integrator.py, diff/inverse.py). Shapes
are unchanged.

Every 3×3 product is written out elementwise and the triangle inverses
come from the adjugate, in float32, so no matmul (hence no TF32) enters.
The Morton codes are uint32 arithmetic carried in int64 (as core/rng.py
carries PCG2D), and the re-sort is stable, as ``jnp.argsort`` is.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gdpathtracing_torch.scene.scene import ISECT_CHUNK, Scene


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """10-bit integers (int64) → their bits spread to every third place."""
    mask = 0xFFFFFFFF
    v = v & mask
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_codes(points: torch.Tensor, lo, span) -> torch.Tensor:
    """(n, 3) f32 points → (n,) 30-bit Morton codes (int64) of their cells
    in a 1024³ grid over [lo, lo + span]."""
    q = torch.clamp((points - lo) / span * 1023.0, 0.0, 1023.0).to(
        torch.int64)
    return (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
            | (_spread_bits(q[:, 2]) << 2))


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3), cofactor expansion along row 0."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def _inv3(m: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """Inverses of (..., 3, 3) with determinants ``det``: the adjugate over
    the determinant."""
    def c(i, j):  # cofactor (i, j)
        r = [k for k in range(3) if k != i]
        s = [k for k in range(3) if k != j]
        minor = m[..., r[0], s[0]] * m[..., r[1], s[1]] \
            - m[..., r[0], s[1]] * m[..., r[1], s[0]]
        return minor if (i + j) % 2 == 0 else -minor

    inv_det = 1.0 / det
    return torch.stack([torch.stack([c(j, i) * inv_det for j in range(3)],
                                    dim=-1) for i in range(3)], dim=-2)


def _matvec3(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) × (..., 3) → (..., 3), each row summed left to right."""
    return torch.stack([m[..., a, 0] * x[..., 0] + m[..., a, 1] * x[..., 1]
                        + m[..., a, 2] * x[..., 2] for a in range(3)], dim=-1)


def _affine_inverse_batch(tf: torch.Tensor) -> torch.Tensor:
    """(I, 3, 4) → (I, 3, 4) inverse affines."""
    r = tf[:, :, :3]
    r_inv = _inv3(r, _det3(r))
    t = -_matvec3(r_inv, tf[:, :, 3])
    return torch.cat([r_inv, t[:, :, None]], dim=2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _transform_points(tf: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(E, 3, 4) affines applied to (E, V, 3) points → (E, V, 3)."""
    return _matvec3(tf[:, None, :, :3], p) + tf[:, None, :, 3]


def build_shade_rows(scene: Scene, transforms: torch.Tensor,
                     isect_inst: torch.Tensor, isect_tri: torch.Tensor
                     ) -> torch.Tensor:
    """(E, 16) packed shading rows (scene/scene.py ``build_shade_rows``) of
    the expanded triangles (``isect_inst``, ``isect_tri``) under
    ``transforms``: world normals, uvs, material id."""
    inst, tri = isect_inst.long(), isect_tri.long()
    tf = transforms.index_select(0, inst)                    # (E, 3, 4)
    world_n = _matvec3(tf[:, None, :, :3], scene.tri_normal[tri])
    uv = scene.tri_uv[tri]                                   # (E, 3, 2)
    slot = torch.clamp(scene.tri_slot[tri],
                       max=scene.inst_materials.shape[1] - 1).long()
    mat = scene.inst_materials[inst, slot]
    e = world_n.shape[0]
    return torch.cat([world_n.reshape(e, 9), uv.reshape(e, 6),
                      mat.reshape(e, 1).to(torch.float32)], dim=1)


def update_instance_transforms(scene: Scene,
                               transforms: torch.Tensor) -> Scene:
    """Move instances: new (I, 3, 4) world-from-object affines. Every table
    the traversal and shading read is rebuilt from them in the graph."""
    transforms = torch.as_tensor(transforms, dtype=torch.float32,
                                 device=scene.device)
    inv = _affine_inverse_batch(transforms)

    # The expanded world-space triangles and their unit-space columns.
    tri = scene.tri_pos[scene.isect_tri.long()]         # (E, 3, 3) object
    world = _transform_points(transforms.index_select(0, scene.isect_inst),
                              tri)
    w0 = world[:, 0]
    e1 = world[:, 1] - w0
    e2 = world[:, 2] - w0
    m = torch.stack([e1, e2, _cross(e1, e2)], dim=-1)   # (E, 3, 3) columns
    det = _det3(m)
    ok = (torch.abs(det) > 1e-18)[:, None, None]
    eye = torch.eye(3, dtype=torch.float32, device=m.device)
    m_safe = torch.where(ok, m, eye)
    minv = torch.where(ok, _inv3(m_safe, _det3(m_safe)), 0.0)
    c = -_matvec3(minv, w0)
    cols = torch.cat([minv, c[:, :, None]], dim=2)      # (E, 3, 4)

    # The Morton re-sort of the expanded triangles by world centroid.
    cent = world.mean(dim=1)
    lo = cent.amin(dim=0)
    span = torch.clamp(cent.amax(dim=0) - lo, min=1e-12)
    order = torch.argsort(morton_codes(cent.detach(), lo.detach(),
                                       span.detach()), stable=True)
    cols, world = cols[order], world[order]
    inst_ids = scene.isect_inst[order]
    tri_ids = scene.isect_tri[order]
    light_ids = scene.isect_light[order]

    n_chunks = scene.isect_mu.shape[1] // ISECT_CHUNK
    wc = world.reshape(n_chunks, -1, 3)
    chunk_bounds = torch.cat([wc.amin(dim=1).T, wc.amax(dim=1).T,
                              wc.new_zeros((2, n_chunks))], dim=0)
    mu, mv, mw = cols[:, 0, :].T, cols[:, 1, :].T, cols[:, 2, :].T

    # TLAS refit: leaf boxes from the transformed BLAS root corners, then
    # the internal nodes children first (the static tlas_refit_order).
    root_min = scene.node_min[scene.inst_root.long()]   # (I, 3)
    root_max = scene.node_max[scene.inst_root.long()]
    corners = torch.stack([
        torch.stack([root_max[:, a] if (k >> a) & 1 else root_min[:, a]
                     for a in range(3)], dim=-1)
        for k in range(8)], dim=1)                      # (I, 8, 3)
    wcorners = _transform_points(transforms, corners)
    inst_min, inst_max = wcorners.amin(dim=1), wcorners.amax(dim=1)
    tmin = list(scene.tlas_min.unbind(0))
    tmax = list(scene.tlas_max.unbind(0))
    for i in range(scene.n_instances):
        tmin[1 + i], tmax[1 + i] = inst_min[i], inst_max[i]
    if scene.tlas_refit_order:
        left, right = scene.tlas_left.tolist(), scene.tlas_right.tolist()
        for i in scene.tlas_refit_order:
            tmin[i] = torch.minimum(tmin[left[i]], tmin[right[i]])
            tmax[i] = torch.maximum(tmax[left[i]], tmax[right[i]])
    else:  # a single-instance TLAS: slot 0 is the leaf's copy
        tmin[0], tmax[0] = inst_min[0], inst_max[0]

    return dataclasses.replace(
        scene,
        inst_transform=transforms, inst_inv_transform=inv,
        isect_mu=mu.contiguous(), isect_mv=mv.contiguous(),
        isect_mw=mw.contiguous(),
        isect_cols=torch.cat([mu.T, mv.T, mw.T], dim=1),
        isect_inst=inst_ids, isect_tri=tri_ids, isect_light=light_ids,
        isect_chunk_bounds=chunk_bounds,
        isect_shade=build_shade_rows(scene, transforms, inst_ids, tri_ids),
        tlas_min=torch.stack(tmin), tlas_max=torch.stack(tmax))


def refit_blas(scene: Scene) -> Scene:
    """Refit the BLAS boxes after ``tri_pos`` moved (topology kept): leaves
    from their (at most 4) triangles, then repeated parent passes, enough
    for the deepest path."""
    tri_min = scene.tri_pos.amin(dim=1)
    tri_max = scene.tri_pos.amax(dim=1)
    count = scene.node_count.long()
    first = scene.node_first.long()
    is_leaf = (count > 0)[:, None]
    b = scene.node_min.shape[0]
    lmin = torch.full((b, 3), math.inf, dtype=torch.float32,
                      device=tri_min.device)
    lmax = torch.full((b, 3), -math.inf, dtype=torch.float32,
                      device=tri_min.device)
    for k in range(4):
        sel = (k < count)[:, None]
        idx = torch.clamp(first + k, max=tri_min.shape[0] - 1)
        lmin = torch.where(sel, torch.minimum(lmin, tri_min[idx]), lmin)
        lmax = torch.where(sel, torch.maximum(lmax, tri_max[idx]), lmax)
    node_min = torch.where(is_leaf, lmin, scene.node_min)
    node_max = torch.where(is_leaf, lmax, scene.node_max)

    depth = max(2 * math.ceil(math.log2(max(scene.n_tris, 2))) + 2, 4)
    left, right = scene.node_left.long(), scene.node_right.long()
    for _ in range(depth):
        node_min = torch.where(is_leaf, node_min,
                               torch.minimum(node_min[left], node_min[right]))
        node_max = torch.where(is_leaf, node_max,
                               torch.maximum(node_max[left], node_max[right]))
    return dataclasses.replace(scene, node_min=node_min, node_max=node_max)


def update_vertices(scene: Scene, tri_pos: torch.Tensor) -> Scene:
    """Deform mesh vertices: refit the BLAS and rebuild the world-space
    tables and the TLAS."""
    scene = dataclasses.replace(scene, tri_pos=torch.as_tensor(
        tri_pos, dtype=torch.float32, device=scene.device))
    return update_instance_transforms(refit_blas(scene), scene.inst_transform)
