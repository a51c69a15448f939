"""Instanced two-level acceleration structure: a TLAS over object-space
BLASes (counterpart of rtxpt_tpu/ops/instanced.py; RTXPT/Sample.cpp:
1353-1421's per-frame TLAS build over object-space BLASes).

  * one BVH8 per mesh that some instance uses, built in object space with
    `collapse_bvh8_np` at LEAF_SIZE, every leaf slot's opacity mask all
    set; the tables are padded to a common row count S and stacked
    (M, S, W);
  * per instance its world AABB, world->object transform, first flat
    triangle and whether its transform mirrors (the flat winding was
    flipped by SceneBuilder.finish());
  * a trace walks the instances of each mesh in chunks of INST_CHUNK, and
    each chunk in near-to-far rounds: every ray picks its nearest
    not-yet-visited instance whose box it enters before its best t, the
    ray goes to that instance's object space (the direction transformed
    unnormalized, so t is the world t), and one K5 launch
    (`traverse_bvh8.trace_bvh8`) traces the whole wavefront against the
    mesh's table with t_max = the best t so far;
  * rigid animation is `set_instance_transform`: one instance's rows, no
    BLAS rebuild (the reference's UpdateInstance path).

The reference's bf16 node and leaf planes (its TPU kernel's matrix-unit
gathers) are not carried: K5 reads the f32 tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import traverse_bvh8 as T8
from .bvh import LEAF_SIZE, build_bvh, collapse_bvh8_np
from .intersect import Hit

# instance chunk width: bounds the entry-distance matrix of a chunk at
# N * INST_CHUNK floats
INST_CHUNK = 256


@dataclasses.dataclass
class InstancedTL:
    mesh_tables: torch.Tensor      # (M, S, W) f32 object-space BVH8 tables
    mesh_leaf_tris: torch.Tensor   # (M, S*ls) i32 mesh-local triangle ids
    mesh_leaf_omm: torch.Tensor    # (M, S*ls) i32 opacity masks, all set
    inst_mesh: torch.Tensor        # (I,) i32 mesh of each instance
    inst_inv: torch.Tensor         # (I, 3, 4) f32 world -> object
    inst_aabb: torch.Tensor        # (I, 6) f32 world AABB
    inst_tri_offset: torch.Tensor  # (I,) i32 first flat triangle
    inst_flip: torch.Tensor        # (I,) bool mirrored winding
    inst_by_mesh: torch.Tensor     # (M, Imax) i32 instance ids, -1 padded
    leaf_size: int
    rows: int                      # S
    # instances of each mesh (the unpadded length of its inst_by_mesh
    # row), read from inst_by_mesh where not given
    mesh_instances: tuple = None

    def __post_init__(self):
        if self.mesh_instances is None:
            self.mesh_instances = tuple(
                (self.inst_by_mesh >= 0).sum(1).cpu().tolist())

    @property
    def num_instances(self) -> int:
        return self.inst_aabb.shape[0]

    @property
    def num_meshes(self) -> int:
        return self.mesh_tables.shape[0]


def _invert_affine(xf: np.ndarray) -> np.ndarray:
    inv_lin = np.linalg.inv(xf[:, :3])
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = inv_lin
    out[:, 3] = -inv_lin @ xf[:, 3]
    return out


def _world_aabb(positions: np.ndarray, xf: np.ndarray) -> np.ndarray:
    p = positions @ xf[:, :3].T + xf[:, 3]
    return np.concatenate([p.min(0), p.max(0)]).astype(np.float32)


def build_instanced(instancing: dict, device="cuda") -> InstancedTL:
    """Host build from SceneBuilder.finish()["instancing"], uploaded to
    `device` (rtxpt_tpu/ops/instanced.py:87-145)."""
    meshes = instancing["meshes"]
    mesh_of = np.asarray(instancing["mesh_of_instance"], np.int64)
    xforms = np.asarray(instancing["transforms"], np.float32)
    used = sorted(set(mesh_of.tolist()))
    remap = {m: i for i, m in enumerate(used)}
    blas = []
    for m in used:
        g = meshes[m]
        blas.append(collapse_bvh8_np(build_bvh(g["positions"], g["indices"]),
                                     g["positions"], g["indices"]))
    s_rows = max(b[0].shape[0] for b in blas)
    width = blas[0][0].shape[1]
    k = len(blas)
    tables = np.zeros((k, s_rows, width), np.float32)
    leaf_tris = np.full((k, s_rows * LEAF_SIZE), -1, np.int32)
    for i, (table, lt, _, _) in enumerate(blas):
        tables[i, :table.shape[0]] = table
        leaf_tris[i, :lt.shape[0]] = lt
    n_inst = mesh_of.shape[0]
    inst_mesh = np.asarray([remap[int(m)] for m in mesh_of], np.int32)
    groups = [np.nonzero(inst_mesh == g)[0] for g in range(k)]
    by_mesh = np.full((k, max(len(g) for g in groups)), -1, np.int32)
    for g, ids in enumerate(groups):
        by_mesh[g, :len(ids)] = ids
    inv = np.stack([_invert_affine(xforms[i]) for i in range(n_inst)])
    aabb = np.stack([_world_aabb(meshes[int(mesh_of[i])]["positions"],
                                 xforms[i]) for i in range(n_inst)])
    flip = np.asarray([np.linalg.det(xforms[i][:, :3]) < 0.0
                       for i in range(n_inst)])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return InstancedTL(
        mesh_tables=t(tables), mesh_leaf_tris=t(leaf_tris),
        mesh_leaf_omm=t(np.full(leaf_tris.shape, 0xFFFF, np.int32)),
        inst_mesh=t(inst_mesh), inst_inv=t(inv.astype(np.float32)),
        inst_aabb=t(aabb),
        inst_tri_offset=t(np.asarray(instancing["tri_offset"], np.int32)),
        inst_flip=t(flip), inst_by_mesh=t(by_mesh),
        leaf_size=LEAF_SIZE, rows=s_rows)


def set_instance_transform(tl: InstancedTL, instancing: dict, index: int,
                           xf: np.ndarray) -> InstancedTL:
    """Rigid motion of instance `index` to transform `xf` (3,4): a copy of
    `tl` with that instance's inverse, world AABB and mirror flag
    replaced; the BLASes are untouched (rtxpt_tpu/ops/instanced.py:
    148-168)."""
    xf = np.asarray(xf, np.float32)
    mesh = instancing["meshes"][int(instancing["mesh_of_instance"][index])]
    dev = tl.inst_inv.device
    inv, aabb, flip = (tl.inst_inv.clone(), tl.inst_aabb.clone(),
                       tl.inst_flip.clone())
    inv[index] = torch.as_tensor(_invert_affine(xf), device=dev)
    aabb[index] = torch.as_tensor(_world_aabb(mesh["positions"], xf),
                                  device=dev)
    flip[index] = bool(np.linalg.det(xf[:, :3]) < 0.0)
    return dataclasses.replace(tl, inst_inv=inv, inst_aabb=aabb,
                               inst_flip=flip)


def _top_slabs_subset(tl: InstancedTL, ids, origins, dirs, t_min, t_max):
    """Ray-vs-instance-box tests for a chunk of instance ids (K,) i64:
    (hit (N,K) bool, entry t (N,K) f32) (rtxpt_tpu/ops/instanced.py:
    171-187). The inverse direction clamps |d| < 1e-12 to +-1e-12; the
    slabs run one axis at a time, which gives the same min/max as the
    reference's (N, K, 3) form with a third of its memory."""
    inv = 1.0 / torch.where(dirs.abs() < 1e-12,
                            torch.where(dirs < 0, -1e-12, 1e-12), dirs)
    box = tl.inst_aabb[ids]                                  # (K,6)
    tn = tf = None
    for a in range(3):
        t0 = (box[None, :, a] - origins[:, a:a + 1]) * inv[:, a:a + 1]
        t1 = (box[None, :, a + 3] - origins[:, a:a + 1]) * inv[:, a:a + 1]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    tn = torch.clamp(tn, min=t_min)
    tf = torch.minimum(tf, t_max[:, None])
    return tn <= tf, tn


def _to_object(inv, v, point: bool):
    """inv (N,3,4) applied to v (N,3): rows of the linear part dotted with
    v, plus the translation for a point."""
    out = (inv[:, :, 0] * v[:, 0:1] + inv[:, :, 1] * v[:, 1:2]
           + inv[:, :, 2] * v[:, 2:3])
    return out + inv[:, :, 3] if point else out


def _trace_mesh_rounds(tl: InstancedTL, m: int, origins, dirs, t_min, t_max,
                       best, active, any_hit: bool, ids, stats=None):
    """Rays against a chunk `ids` of mesh m's instances in near-to-far
    rounds (rtxpt_tpu/ops/instanced.py:195-268): each round every active
    ray picks its nearest overlapped instance whose entry t lies strictly
    after the previous visit's and strictly before its best t, and one K5
    launch traces the wavefront against mesh m's table. The strict `>`
    skips an instance whose entry t equals the one just visited (rays
    starting inside several boxes, whose entries all clamp to t_min), as
    the reference does. Rounds stop when no ray has a candidate (any-hit:
    or every active ray is occluded), at most one a chunk instance. A
    round in which no ray has a candidate launches nothing: the
    reference's last round of a chunk traces no active lane and changes
    nothing."""
    bt, bp, bu, bv = best
    n = origins.shape[0]
    idsc = ids.clamp(min=0).long()
    hit_c, tn_c = _top_slabs_subset(tl, idsc, origins, dirs, t_min, t_max)
    tn_m = torch.where((ids >= 0)[None, :] & hit_c, tn_c, torch.inf)
    del hit_c, tn_c
    table, omm = tl.mesh_tables[m], tl.mesh_leaf_omm[m]
    leaf_tris = tl.mesh_leaf_tris[m]
    tn_prev = torch.full((n,), -torch.inf, device=origins.device)
    rounds = 0
    while rounds < ids.shape[0]:
        key = torch.where((tn_m < bt[:, None]) & (tn_m > tn_prev[:, None]),
                          tn_m, torch.inf)
        # torch.argmin returns the first minimal index, as jnp.argmin
        sel = torch.argmin(key, dim=1)
        sel_tn = key.gather(1, sel[:, None])[:, 0]
        del key
        has = torch.isfinite(sel_tn) & active
        if not bool(has.any()):
            break
        inst = idsc[sel]
        inv = tl.inst_inv[inst]
        o_obj = _to_object(inv, origins, True).contiguous()
        d_obj = _to_object(inv, dirs, False).contiguous()
        t, slot, uv = T8.trace_bvh8(table, omm, o_obj, d_obj,
                                    bt.contiguous(), has.contiguous(),
                                    leaf_size=tl.leaf_size, any_hit=any_hit)
        rounds += 1
        local = torch.where(slot >= 0, leaf_tris[slot.clamp(min=0).long()],
                            -1)
        flat = torch.where(local >= 0, local + tl.inst_tri_offset[inst], -1)
        u, v = uv[:, 0], uv[:, 1]
        # mirrored instances flipped the flat winding: (u, v) -> (u, 1-u-v)
        v = torch.where(tl.inst_flip[inst], 1.0 - u - v, v)
        found = has & (flat >= 0) & (t < bt)
        bp = torch.where(found, flat, bp)
        bu = torch.where(found, u, bu)
        bv = torch.where(found, v, bv)
        bt = torch.where(found, t, bt)
        tn_prev = torch.where(has, sel_tn, tn_prev)
        if any_hit and not bool((active & (bp < 0)).any()):
            break
    if stats is not None:
        stats["chunks"] = stats.get("chunks", 0) + 1
        stats["rounds"] = stats.get("rounds", 0) + rounds
    return bt, bp, bu, bv


def _trace(tl: InstancedTL, origins, dirs, t_min, t_max, active,
           any_hit: bool, stats=None):
    n = origins.shape[0]
    dev = origins.device
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=dev).expand(n).contiguous()
    best = (t_max, torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros((n,), device=dev), torch.zeros((n,), device=dev))
    # each mesh's instances in chunks of INST_CHUNK, without the padding
    # of inst_by_mesh: a padding id is never a candidate, and it follows
    # the real ids, so argmin's first minimum is the same
    for m, count in enumerate(tl.mesh_instances):
        for c0 in range(0, count, INST_CHUNK):
            live = active & (best[1] < 0) if any_hit else active
            best = _trace_mesh_rounds(
                tl, m, origins, dirs, float(t_min), t_max, best, live,
                any_hit, tl.inst_by_mesh[m, c0:min(c0 + INST_CHUNK, count)],
                stats)
    return best


def trace_closest(tl: InstancedTL, origins, dirs, t_min=0.0, t_max=1e30,
                  active=None, stats=None) -> Hit:
    """Closest hit over every instance (rtxpt_tpu/ops/instanced.py:
    276-292): prim is the flat scene triangle, t = t_max on a miss. With
    `stats` a dict, adds the chunks traced and their rounds (K5
    launches)."""
    bt, bp, bu, bv = _trace(tl, origins, dirs, t_min, t_max, active, False,
                            stats)
    return Hit(bt, bp, torch.stack([bu, bv], -1))


def trace_anyhit(tl: InstancedTL, origins, dirs, t_min=0.0, t_max=1e30,
                 active=None, stats=None):
    """Occlusion (N,) bool (rtxpt_tpu/ops/instanced.py:295-311): a chunk
    traces only the rays not yet occluded."""
    return _trace(tl, origins, dirs, t_min, t_max, active, True,
                  stats)[1] >= 0
