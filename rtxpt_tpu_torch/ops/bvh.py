"""BVH builds (counterpart of rtxpt_tpu/ops/bvh.py).

Host side (numpy), like the reference's BLAS builds:

  * `build_bvh`: binned-SAH binary BVH from the native builder
    (``csrc/bvh_builder.cpp`` through ``rtxpt_tpu_torch.native``). Child
    codes: >= 0 is a node, < 0 a leaf with start = (-c-1) >> 5 and
    count = (-c-1) & 31 into the leaf-ordered triangle permutation.
  * `collapse_bvh8`: the BVH2 collapsed into the unified 8-wide table the
    trace kernel K5 walks (``ops/traverse_bvh8.py``). A node row holds 8
    child AABBs (48 floats) and 8 child codes stored as exact float values
    (8 floats); a leaf row inlines up to `leaf_size` triangles as
    (p0, e1, e2). Rows are max(56, 9 * leaf_size) floats wide: 144 at the
    renderer's leaf size, LEAF_SIZE = 16.

Refit after animation keeps the topology and recomputes bounds (the
per-frame skinned-BLAS update, Sample.cpp:1355-1380): `refit` for the
BVH2, and for the BVH8 `refit_topology`, the child codes and depth levels
of its node rows, read from the table's own code columns (48:56), so that
a table carried across from the reference refits with the reference's
topology (scene/animation.py `refit_bvh8` sweeps them).

The reference also packs the table into bf16 planes for its TPU kernel's
matrix-unit gathers; the CUDA kernel reads the float32 rows directly, so
the port carries only the table.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import native

LEAF_MAX = 31          # count bits in the leaf encoding
EMPTY_LEAF = -1        # start=0, count=0
LEAF_SIZE = 16         # triangles per BVH8 leaf row: rows of 9 * 16 floats
STACK_DEPTH = 48       # K5's per-ray traversal stack (csrc/bvh8_trace.cu)
CODE_LIMIT = 1 << 24   # child codes ride the table as exact f32 values


def encode_leaf(start: int, count: int) -> int:
    assert 0 <= count <= LEAF_MAX
    return -((start << 5) | count) - 1


def decode_leaf(code):
    v = -code - 1
    return v >> 5, v & LEAF_MAX


class BVH2(NamedTuple):
    child_bounds: np.ndarray   # (N,12) f32 [lmin, lmax, rmin, rmax]
    child_idx: np.ndarray      # (N,2) i32 (>=0 node, <0 leaf code)
    order: np.ndarray          # (T,) i32 leaf order -> original triangle
    levels: tuple              # node ids by depth, deepest last

    @property
    def num_nodes(self) -> int:
        return self.child_bounds.shape[0]


def build_bvh(positions, indices, leaf_size: int = 4) -> BVH2:
    """Binned-SAH BVH2 (native builder; raises if it cannot be built)."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    if indices.shape[0] == 0:
        return BVH2(np.zeros((1, 12), np.float32),
                    np.full((1, 2), EMPTY_LEAF, np.int32),
                    np.zeros((0,), np.int32), (np.asarray([0]),))
    bounds, child, depth, order = native.build_bvh_native(
        positions, indices, leaf_size)
    levels = tuple(np.where(depth == d)[0]
                   for d in range(int(depth.max()) + 1))
    return BVH2(child_bounds=bounds, child_idx=child,
                order=order.astype(np.int32), levels=levels)


@dataclasses.dataclass
class BVH8:
    """Unified 8-wide BVH on one torch device."""
    table: torch.Tensor       # (R, W) f32 node and leaf rows
    leaf_tris: torch.Tensor   # (R * leaf_size,) i32 original triangle ids
    leaf_omm: torch.Tensor    # (R * leaf_size,) i32 16-bit opacity masks
    leaf_size: int
    num_nodes: int
    # refit_topology's (codes, levels), computed on first use; refits keep
    # the codes, so a refitted copy shares it
    topology: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                  compare=False)

    @property
    def num_rows(self) -> int:
        return self.table.shape[0]


def refit_topology(bvh8: BVH8):
    """(codes (Nn, 8) i64 tensor on the table's device, levels: tuple of
    i64 tensors of node-row ids by depth, root first) from the table's
    code columns 48:56, cached on `bvh8`. Levels are found breadth-first
    from the root, the reference's depth (`collapse_bvh8` refit_info)."""
    if bvh8.topology is None:
        codes = bvh8.table[:bvh8.num_nodes, 48:56].cpu().numpy() \
            .astype(np.int64)
        levels, frontier = [], np.zeros(1, np.int64)
        while frontier.size:
            levels.append(frontier)
            kids = codes[frontier].reshape(-1)
            frontier = np.sort(kids[kids >= 0])
        dev = bvh8.table.device
        bvh8.topology = (torch.as_tensor(codes, device=dev),
                         tuple(torch.as_tensor(lv, device=dev)
                               for lv in levels))
    return bvh8.topology


def refit(bvh: BVH2, positions, indices) -> BVH2:
    """Bottom-up refit of a BVH2's child bounds after vertex animation,
    topology unchanged (rtxpt_tpu/ops/bvh.py:575-615), host side: each
    leaf's bounds over its triangles' vertices (all of them; the
    reference reads at most 8, its builds' leaf size), each node's over
    its children's, deepest level first. No render path traces a BVH2."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int64)
    tri = positions[indices[np.asarray(bvh.order, np.int64)]]  # (T,3,3)
    tmin, tmax = tri.min(axis=1), tri.max(axis=1)
    cb = np.array(bvh.child_bounds, np.float32)
    ci = np.asarray(bvh.child_idx)
    ks = np.arange(LEAF_MAX)

    def leaf_bounds(code):
        start, count = decode_leaf(code)
        idx = np.clip(start[:, None] + ks[None, :], 0,
                      max(tmin.shape[0] - 1, 0))
        valid = (ks[None, :] < count[:, None])[..., None]
        return (np.where(valid, tmin[idx], np.inf).min(axis=1),
                np.where(valid, tmax[idx], -np.inf).max(axis=1))

    for level in bvh.levels[::-1]:
        ids = np.asarray(level, np.int64)
        new_b = []
        for side in range(2):
            c = ci[ids, side].astype(np.int64)
            is_leaf = c < 0
            llo, lhi = leaf_bounds(np.where(is_leaf, c, -1))
            nb = cb[np.where(is_leaf, 0, c)]
            lo = np.where(is_leaf[:, None], llo,
                          np.minimum(nb[:, 0:3], nb[:, 6:9]))
            hi = np.where(is_leaf[:, None], lhi,
                          np.maximum(nb[:, 3:6], nb[:, 9:12]))
            new_b += [lo, hi]
        cb[ids] = np.concatenate(new_b, axis=-1)
    return BVH2(cb, bvh.child_idx, bvh.order, bvh.levels)


def node_tri_ranges(bvh: BVH2):
    """Per-BVH2-node [start, end) into the leaf order (bottom-up)."""
    ci = np.asarray(bvh.child_idx)
    start = np.zeros(ci.shape[0], np.int64)
    end = np.zeros(ci.shape[0], np.int64)

    def code_range(code):
        if code < 0:
            s, c = decode_leaf(int(code))
            return s, s + c
        return start[code], end[code]

    for level in bvh.levels[::-1]:
        for nid in level:
            ls_, le_ = code_range(ci[nid, 0])
            rs_, re_ = code_range(ci[nid, 1])
            start[nid], end[nid] = min(ls_, rs_), max(le_, re_)
    return start, end


def collapse_bvh8_np(bvh: BVH2, positions, indices,
                     leaf_collapse: int = LEAF_SIZE, tri_omm=None):
    """Collapse a BVH2 into the unified table (host side) ->
    (table (R,W) f32, leaf_tris (R*ls,) i32, leaf_omm (R*ls,) i32,
    num_nodes). Subtrees of at most leaf_collapse triangles become single
    leaves; otherwise the 8 child slots are filled by repeatedly
    splitting the slot with the largest triangle count. Raises when the
    tree needs a deeper stack than K5's or codes beyond 2^24."""
    cb2 = np.asarray(bvh.child_bounds)
    ci2 = np.asarray(bvh.child_idx)
    assert leaf_collapse <= LEAF_MAX
    start, end = node_tri_ranges(bvh)

    def subtree_count(code):
        if code < 0:
            return decode_leaf(int(code))[1]
        return end[code] - start[code]

    out_bounds: list = []
    out_idx: list = []

    def build8(code, bounds) -> int:
        cnt = subtree_count(code)
        if code < 0:
            return int(code)
        if cnt <= leaf_collapse:
            return encode_leaf(int(start[code]), int(cnt))
        slots = [(int(code), bounds)]
        while len(slots) < 8:
            # split the internal slot with the largest triangle count
            best = -1
            for i, (c, _) in enumerate(slots):
                if c >= 0 and subtree_count(c) > leaf_collapse:
                    if best < 0 or subtree_count(c) > \
                            subtree_count(slots[best][0]):
                        best = i
            if best < 0:
                break
            c, _ = slots.pop(best)
            slots.append((int(ci2[c, 0]), cb2[c, 0:6]))
            slots.append((int(ci2[c, 1]), cb2[c, 6:12]))
        node_id = len(out_bounds)
        out_bounds.append(np.zeros(48, np.float32))
        out_idx.append(np.full(8, EMPTY_LEAF, np.int32))
        for i, (c, b) in enumerate(slots):
            out_bounds[node_id][i * 6:(i + 1) * 6] = b
            out_idx[node_id][i] = build8(c, b)
        # empty slots get inverted bounds so the slab test always misses
        for i in range(len(slots), 8):
            out_bounds[node_id][i * 6:i * 6 + 3] = 1e30
            out_bounds[node_id][i * 6 + 3:i * 6 + 6] = -1e30
        return node_id

    root_bounds = np.concatenate([
        np.minimum(cb2[0, 0:3], cb2[0, 6:9]),
        np.maximum(cb2[0, 3:6], cb2[0, 9:12])])
    import sys
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))
    root = build8(0, root_bounds)
    if root != 0 or not out_bounds:
        # tiny scene: build8 returned a leaf code; wrap it in a root node
        node = np.zeros(48, np.float32)
        node[0:6] = root_bounds
        for i in range(1, 8):
            node[i * 6:i * 6 + 3] = 1e30
            node[i * 6 + 3:i * 6 + 6] = -1e30
        idx = np.full(8, EMPTY_LEAF, np.int32)
        idx[0] = root
        out_bounds.insert(0, node)
        out_idx.insert(0, idx)
        for row in out_idx:
            row[row >= 0] += 1

    # ---- pack the unified table
    n_nodes = len(out_bounds)
    idx_mat = np.stack(out_idx)                      # (n_nodes, 8)
    leaf_codes = sorted({int(c) for c in idx_mat.reshape(-1)
                         if c < 0 and c != EMPTY_LEAF})
    leaf_row_of = {c: n_nodes + i for i, c in enumerate(leaf_codes)}
    n_leaves = len(leaf_codes)
    width = max(56, 9 * leaf_collapse)
    table = np.zeros((n_nodes + n_leaves, width), np.float32)
    leaf_tris = np.full((n_nodes + n_leaves, leaf_collapse), -1, np.int32)
    order = np.asarray(bvh.order)
    positions = np.asarray(positions)
    indices = np.asarray(indices)

    def remap(code):
        if code >= 0 or code == EMPTY_LEAF:
            return code
        _, c = decode_leaf(int(code))
        return encode_leaf(leaf_row_of[int(code)], c)

    for i in range(n_nodes):
        table[i, 0:48] = out_bounds[i]
        table[i, 48:56] = np.asarray([remap(c) for c in idx_mat[i]],
                                     np.int32).astype(np.float32)
    for code, row in leaf_row_of.items():
        s, c = decode_leaf(code)
        tri_ids = order[s:s + c]
        leaf_tris[row, :c] = tri_ids
        p = positions[indices[tri_ids]]               # (c,3,3)
        p0 = p[:, 0]
        table[row, :c * 9] = np.concatenate(
            [p0, p[:, 1] - p0, p[:, 2] - p0], axis=1).reshape(-1)

    # traversal-safety contracts, checked at build time: the stack grows
    # by at most 7 a level plus the root, and K5 clamps pushes at its last
    # slot; child codes are exact in f32 only below 2^24
    codes = table[:n_nodes, 48:56].astype(np.int32)
    depth = np.zeros(n_nodes, np.int64)
    for i in range(n_nodes):             # parents precede their children
        kids = codes[i][codes[i] >= 0]
        depth[kids] = depth[i] + 1
    n_levels = int(depth.max()) + 1
    max_stack = 7 * n_levels + 8
    if max_stack > STACK_DEPTH:
        raise ValueError(
            f"BVH8 depth {n_levels} needs stack {max_stack} > "
            f"{STACK_DEPTH}; increase STACK_DEPTH or leaf_collapse")
    max_code = max((abs(int(c)) for c in idx_mat.reshape(-1)), default=0)
    max_leaf_code = (n_nodes + n_leaves) << 5 | LEAF_MAX
    if max(max_code, max_leaf_code) >= CODE_LIMIT:
        raise ValueError(
            f"BVH8 child code {max(max_code, max_leaf_code)} not exactly "
            "representable in f32 (>= 2^24 rows*32); scene too large for "
            "the unified table")
    leaf_omm = np.full(leaf_tris.shape, 0xFFFF, np.int32)
    if tri_omm is not None:
        lv = leaf_tris >= 0
        leaf_omm[lv] = np.asarray(tri_omm, np.int32)[leaf_tris[lv]]
    return table, leaf_tris.reshape(-1), leaf_omm.reshape(-1), n_nodes


def collapse_bvh8(bvh: BVH2, positions, indices, tri_omm=None,
                  device="cuda") -> BVH8:
    """`collapse_bvh8_np` at LEAF_SIZE, each leaf slot with its triangle's
    opacity mask (`tri_omm` (T,) of scene/omm.py; all cells set where
    None), uploaded to `device`."""
    table, leaf_tris, leaf_omm, n_nodes = collapse_bvh8_np(
        bvh, positions, indices, tri_omm=tri_omm)
    return BVH8(table=torch.as_tensor(table, device=device),
                leaf_tris=torch.as_tensor(leaf_tris, device=device),
                leaf_omm=torch.as_tensor(leaf_omm, device=device),
                leaf_size=LEAF_SIZE, num_nodes=n_nodes)
