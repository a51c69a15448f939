"""Two-level BVH8 for scenes over 45,000 triangles (counterpart of
rtxpt_tpu/ops/bvh2l.py).

The scene BVH2 is cut into K spatial subtrees of at most `cap_tris`
triangles; each collapses into its own BVH8 table, padded to a common row
count S and stacked (K, S, W). The top level is the K subtree AABBs.

A trace is one call of `traverse_bvh8.trace_bvh8_2l`: on CUDA tensors one
launch of ``csrc/bvh8_trace.cu`` in which each thread tests the K boxes,
walks its subtrees and looks up the global triangle id; on CPU tensors
`trace_two_level_plain`, the composition that launch reproduces bit for
bit:

  * slab-test the K boxes per ray (`_top_slabs`);
  * for K >= PROBE_MIN_SUBTREES, probe each ray's nearest overlapped
    subtree first (the first minimal entry t), with K6's plain version
    over the stacked tables and a per-ray subtree index, over rays stably
    sorted by that index;
  * sweep the subtrees in ascending index with K5's plain version, over
    the rays whose box of that subtree is hit and, for closest hits,
    entered strictly before the best t so far (any-hit: not yet
    occluded);
  * scatter the results back to the caller's ray order.

So a tie between subtrees goes to the ray's nearest subtree, then to the
lowest index. The reference picked one subtree per tile of rays (scalar
prefetch), and left the lanes that straddled a tile boundary to the
sweep; here every overlapped ray probes its own nearest subtree. Its bf16
planes are not carried (the kernels read the f32 tables).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import traverse_bvh8 as T8
from .bvh import (LEAF_MAX, LEAF_SIZE, build_bvh, collapse_bvh8_np,
                  node_tri_ranges)
from .intersect import Hit, safe_inv

# the reference's subtree cap (4096 rows x 16 triangles / 3, sized there
# for the TPU's VMEM); kept so the partition has the reference's shape
CAP_TRIS = 4096 * 16 // 3
PROBE_MIN_SUBTREES = 8   # the probe pays off only with many subtrees


@dataclasses.dataclass
class BVH8TwoLevel:
    sub_tables: torch.Tensor     # (K, S, W) f32 stacked BVH8 tables
    sub_leaf_tris: torch.Tensor  # (K, S*ls) i32 global triangle ids
    sub_leaf_omm: torch.Tensor   # (K, S*ls) i32 opacity masks
    sub_aabb: torch.Tensor       # (K, 6) f32 min.xyz max.xyz
    leaf_size: int
    rows: int                    # S

    @property
    def num_subtrees(self) -> int:
        return self.sub_aabb.shape[0]


def build_two_level(positions, indices, *, cap_tris: int = CAP_TRIS,
                    tri_omm=None, device="cuda") -> BVH8TwoLevel:
    """Partition the scene along a cut of its SAH tree and build one BVH8
    per subtree (host side, leaves of LEAF_SIZE triangles, each leaf slot
    with its triangle's opacity mask `tri_omm` (T,), all cells set where
    None), then upload the stacked tables."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    top = build_bvh(positions, indices)
    ci = top.child_idx
    start, end = node_tri_ranges(top)
    order = top.order

    # DFS cut: a node becomes a subtree root when its range fits the cap
    roots = []
    todo = [0]
    while todo:
        code = todo.pop()
        if code < 0:
            v = -int(code) - 1
            roots.append((v >> 5, (v >> 5) + (v & LEAF_MAX)))
        elif end[code] - start[code] <= cap_tris:
            roots.append((int(start[code]), int(end[code])))
        else:
            todo.extend(int(c) for c in ci[code][::-1] if c != -1)
    # merge adjacent small ranges so K stays small
    roots.sort()
    merged = []
    for lo, hi in roots:
        if merged and hi - merged[-1][0] <= cap_tris and \
                merged[-1][1] == lo:
            merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))

    subs = []
    for lo, hi in merged:
        tri_ids = order[lo:hi]
        sub_idx = indices[tri_ids]
        table, lt, lo_omm, _ = collapse_bvh8_np(
            build_bvh(positions, sub_idx), positions, sub_idx,
            tri_omm=None if tri_omm is None
            else np.asarray(tri_omm)[tri_ids])
        gl = np.where(lt >= 0, tri_ids[np.maximum(lt, 0)], -1)
        p = positions[sub_idx.reshape(-1)]
        subs.append((table, gl.astype(np.int32), lo_omm,
                     np.concatenate([p.min(0), p.max(0)])))

    k = len(subs)
    s_rows = max(s[0].shape[0] for s in subs)
    width = subs[0][0].shape[1]
    ls = LEAF_SIZE
    tables = np.zeros((k, s_rows, width), np.float32)
    leaf_tris = np.full((k, s_rows * ls), -1, np.int32)
    leaf_omms = np.full((k, s_rows * ls), 0xFFFF, np.int32)
    aabbs = np.zeros((k, 6), np.float32)
    for i, (table, gl, lo_omm, aabb) in enumerate(subs):
        r = table.shape[0]
        tables[i, :r] = table
        leaf_tris[i, :r * ls] = gl
        leaf_omms[i, :r * ls] = lo_omm
        aabbs[i] = aabb
    t = lambda a: torch.as_tensor(a, device=device)
    return BVH8TwoLevel(sub_tables=t(tables), sub_leaf_tris=t(leaf_tris),
                        sub_leaf_omm=t(leaf_omms), sub_aabb=t(aabbs),
                        leaf_size=ls, rows=s_rows)


def _top_slabs(tl: BVH8TwoLevel, origins, dirs, t_max):
    """(N,K) hit mask and entry t of the K subtree AABBs (t_min 0)."""
    inv = safe_inv(dirs)
    t0 = (tl.sub_aabb[None, :, 0:3] - origins[:, None]) * inv[:, None]
    t1 = (tl.sub_aabb[None, :, 3:6] - origins[:, None]) * inv[:, None]
    tn = torch.clamp(torch.amax(torch.minimum(t0, t1), -1), min=0.0)
    tf = torch.minimum(torch.amin(torch.maximum(t0, t1), -1),
                       t_max[:, None])
    return tn <= tf, tn


def _probe_order(hit_k, tn_k, active):
    """Nearest overlapped subtree of each ray, and the stable sort of the
    rays by it (rays that overlap none, or are inactive, go last) ->
    (perm, sorted subtree index, sorted probe mask)."""
    near = torch.argmin(torch.where(hit_k, tn_k, torch.inf), dim=1)
    overlapped = hit_k.any(dim=1)
    key = torch.where(active & overlapped, near, hit_k.shape[1])
    perm = torch.argsort(key, stable=True)
    return perm, near[perm].to(torch.int32), (active & overlapped)[perm]


def _unsort(perm, *vals):
    out = []
    for v in vals:
        u = torch.empty_like(v)
        u[perm] = v
        out.append(u)
    return out


def trace_closest(tl: BVH8TwoLevel, origins, dirs, t_max=1e30,
                  active=None) -> Hit:
    """Closest hit; prim is the global triangle id."""
    return T8.trace_bvh8_2l(tl, *T8.prepare_rays(origins, dirs, t_max,
                                                 active), any_hit=False)


def trace_anyhit(tl: BVH8TwoLevel, origins, dirs, t_max=1e30, active=None):
    """True where the segment (0, t_max) is occluded."""
    return T8.trace_bvh8_2l(tl, *T8.prepare_rays(origins, dirs, t_max,
                                                 active), any_hit=True)


def trace_two_level_plain(tl: BVH8TwoLevel, origins, dirs, t_max=1e30,
                          active=None, *, any_hit: bool,
                          stats: dict = None):
    """Plain version of the two-level trace (the module docstring's
    composition, on any device): Hit (closest) or the occlusion flag
    (any-hit). With `stats` a dict, `trace_bvh8_plain` adds the rows of
    every probe and sweep call to it."""
    origins, dirs, t_max, active = T8.prepare_rays(origins, dirs, t_max,
                                                   active)
    if any_hit:
        return _anyhit_plain(tl, origins, dirs, t_max, active, stats)
    return _closest_plain(tl, origins, dirs, t_max, active, stats)


def _closest_plain(tl, origins, dirs, t_max, active, stats):
    n = origins.shape[0]
    k = tl.num_subtrees
    ls = tl.leaf_size
    hit_k, tn_k = _top_slabs(tl, origins, dirs, t_max)
    perm = None
    if k >= PROBE_MIN_SUBTREES:
        perm, near, probe = _probe_order(hit_k, tn_k, active)
        origins, dirs = origins[perm], dirs[perm]
        t_max, active = t_max[perm], active[perm]
        hit_k, tn_k = hit_k[perm], tn_k[perm]
        t_p, slot_p, uv_p = T8.trace_bvh8_plain(
            tl.sub_tables, tl.sub_leaf_omm, origins, dirs, t_max, probe,
            near, leaf_size=ls, any_hit=False, stats=stats)
        found = slot_p >= 0
        gl = tl.sub_leaf_tris.reshape(-1)[
            near.to(torch.int64) * (tl.rows * ls)
            + torch.clamp(slot_p, min=0).to(torch.int64)]
        best_t = torch.where(found, t_p, t_max)
        best_prim = torch.where(found, gl, -1)
        best_uv = torch.where(found[:, None], uv_p, 0.0)
        skip = probe                     # these rays already visited `near`
    else:
        best_t = t_max
        best_prim = torch.full((n,), -1, dtype=torch.int32,
                               device=origins.device)
        best_uv = torch.zeros((n, 2), dtype=torch.float32,
                              device=origins.device)
    for s in range(k):
        want = active & hit_k[:, s] & (tn_k[:, s] < best_t)
        if perm is not None:
            want = want & ~(skip & (near == s))
        t, slot, uv = T8.trace_bvh8_plain(
            tl.sub_tables[s], tl.sub_leaf_omm[s], origins, dirs, best_t,
            want, leaf_size=ls, any_hit=False, stats=stats)
        found = (slot >= 0) & (t < best_t)
        orig = tl.sub_leaf_tris[s][torch.clamp(slot, min=0)]
        best_prim = torch.where(found, orig, best_prim)
        best_uv = torch.where(found[:, None], uv, best_uv)
        best_t = torch.where(found, t, best_t)
    if perm is not None:
        best_t, best_prim, best_uv = _unsort(perm, best_t, best_prim,
                                             best_uv)
    return Hit(best_t, best_prim, best_uv)


def _anyhit_plain(tl, origins, dirs, t_max, active, stats):
    n = origins.shape[0]
    k = tl.num_subtrees
    hit_k, tn_k = _top_slabs(tl, origins, dirs, t_max)
    perm = None
    if k >= PROBE_MIN_SUBTREES:
        perm, near, probe = _probe_order(hit_k, tn_k, active)
        origins, dirs = origins[perm], dirs[perm]
        t_max, active = t_max[perm], active[perm]
        hit_k = hit_k[perm]
        _, slot_p, _ = T8.trace_bvh8_plain(
            tl.sub_tables, tl.sub_leaf_omm, origins, dirs, t_max, probe,
            near, leaf_size=tl.leaf_size, any_hit=True, stats=stats)
        found = slot_p >= 0
    else:
        found = torch.zeros((n,), dtype=torch.bool, device=origins.device)
    for s in range(k):
        want = active & ~found & hit_k[:, s]
        if perm is not None:
            want = want & ~(probe & (near == s))
        _, slot, _ = T8.trace_bvh8_plain(
            tl.sub_tables[s], tl.sub_leaf_omm[s], origins, dirs, t_max,
            want, leaf_size=tl.leaf_size, any_hit=True, stats=stats)
        found = found | (slot >= 0)
    if perm is not None:
        (found,) = _unsort(perm, found)
    return found
