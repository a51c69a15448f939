"""BVH8 closest / any-hit traversal: kernels K5 and K6, and the two-level
trace in one launch (counterpart of rtxpt_tpu/ops/traverse_pallas.py, of
`_trace8` in rtxpt_tpu/ops/traverse.py, the plain loop the reference runs
off the TPU, and of the probe-then-sweep composition of
rtxpt_tpu/ops/bvh2l.py).

Each ray walks a unified BVH8 table (``ops/bvh.py``) with a stack: a
popped row is a node (8 child slab tests, the valid children sorted
far-to-near by a fixed 19-comparator network and pushed) or a leaf (up to
`leaf_size` inlined triangles tested with Möller–Trumbore; the first
smallest t wins, then the 16-bit opacity micro-mask cell of the hit must
be set). K5 and K6 output t (t_max where nothing was hit), the leaf SLOT
(row * leaf_size + k, -1 for a miss) and (u, v); callers map slots to
triangle ids through the table's `leaf_tris`.

`trace_bvh8` (K5, entry point ``rtxpt_bvh8_trace``) walks one table: the
single-`BVH8` tier of ``ops/traverse.py``. `trace_bvh8_sub` (K6,
``rtxpt_bvh8_trace_sub``) walks a stack of K tables (K, S, W), each ray
the one named by its `sub` index (the TPU picked one subtree per ray tile
by scalar prefetch; on the GPU each thread reads its own index).
`trace_bvh8_2l` (``rtxpt_bvh8_trace_2l``) runs a whole two-level trace of
``ops/bvh2l.py`` in one launch: per ray the top-level box tests, the walk
of the nearest overlapped subtree, the walks of the other subtrees in
ascending index, and the lookup of the global triangle id. All three run
``csrc/bvh8_trace.cu`` on CUDA tensors and their plain versions on CPU
tensors (`trace_bvh8_plain`; `bvh2l.trace_two_level_plain` for the
two-level trace), and raise for anything else.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .bvh import LEAF_MAX, STACK_DEPTH
from .intersect import Hit, moller_trumbore, ray_aabb, safe_inv
from ..utils import profiling

MAX_ITERS = 500_000    # pops per walk, as in the reference's `_trace8`
# csrc/bvh8_trace.cu kMaxSubtrees: a block's K boxes and its 128 stacks of
# 48 entries fit in 48 KB of shared memory
MAX_SUBTREES = 1024
# far-to-near sorting network over the 8 child slots (descending t); the
# order of the comparators decides ties
_SORT8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
          (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6),
          (2, 4), (3, 5), (3, 4))


def trace_bvh8_plain(table, leaf_omm, origins, dirs, t_max, active,
                     sub=None, *, leaf_size: int, any_hit: bool,
                     stats: dict = None):
    """Plain version of K5 (sub=None) and K6: the masked wavefront loop
    of the reference's `_trace8`, over the lanes that still hold a stack
    (a lane whose stack empties never refills, so finished lanes leave
    the working set). table (R, W) or (K, S, W) f32; leaf_omm
    (R*leaf_size,) or (K, S*leaf_size) i32; sub (N,) i32 or None.
    Returns (t (N,) f32, slot (N,) i32, uv (N,2) f32). With `stats` a
    dict, adds the node rows, leaf rows and leaf triangles visited, the
    distinct node rows and leaf triangles among them, and one call (and
    one idle call if no lane is active)."""
    dev = origins.device
    n = origins.shape[0]
    if sub is None:
        rows = table.shape[0]
        flat = table
    else:
        rows = table.shape[1]
        flat = table.reshape(-1, table.shape[2])
    omm = leaf_omm.reshape(-1)
    t_out = t_max.clone()
    slot_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    uv_out = torch.zeros((n, 2), dtype=torch.float32, device=dev)

    lane = torch.nonzero(active)[:, 0]
    o, d = origins[lane], dirs[lane]
    inv = safe_inv(d)
    bt = t_max[lane]
    bp = torch.full(lane.shape, -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(lane.shape, dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    base = (torch.zeros_like(lane) if sub is None else
            sub[lane].clamp(0, table.shape[0] - 1).to(torch.int64) * rows)
    # the extra last column takes the pushes of invalid children
    stack = torch.zeros((lane.shape[0], STACK_DEPTH + 1), dtype=torch.int32,
                        device=dev)
    sp = torch.ones(lane.shape, dtype=torch.int32, device=dev)
    ks = torch.arange(leaf_size, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    if stats is not None:
        node_seen = torch.zeros(flat.shape[0], dtype=torch.bool, device=dev)
        leaf_seen = torch.zeros(flat.shape[0], dtype=torch.int64, device=dev)

    def retire(m):
        idx = lane[m]
        t_out[idx] = bt[m]
        slot_out[idx] = bp[m]
        uv_out[idx] = torch.stack([bu[m], bv[m]], -1)

    it = 0
    while lane.numel() and it < MAX_ITERS:
        it += 1
        top = stack.gather(1, (sp - 1).clamp(0, STACK_DEPTH - 1)
                           .to(torch.int64)[:, None])[:, 0]
        sp = sp - 1
        is_leaf = top < 0
        node = ~is_leaf
        v = -torch.where(is_leaf, top, -1) - 1
        leaf_row = v >> 5
        lcount = v & LEAF_MAX
        fetch = torch.where(is_leaf, leaf_row, top).clamp(0, rows - 1)
        row = flat[base + fetch]                              # (L, W)

        # ---- node row: 8 child AABBs + codes
        cb = row[:, :48].reshape(-1, 8, 6)
        ci = row[:, 48:56].to(torch.int32)
        hit8, t8 = ray_aabb(o[:, None], inv[:, None], cb[..., 0:3],
                            cb[..., 3:6], 0.0, bt[:, None])
        hit8 = hit8 & (ci != -1) & node[:, None]
        ts = list(torch.where(hit8, t8, -torch.inf).unbind(1))
        cs = list(ci.unbind(1))
        for a, b in _SORT8:
            swap = ts[a] < ts[b]
            ts[a], ts[b] = (torch.where(swap, ts[b], ts[a]),
                            torch.where(swap, ts[a], ts[b]))
            cs[a], cs[b] = (torch.where(swap, cs[b], cs[a]),
                            torch.where(swap, cs[a], cs[b]))
        off = torch.zeros_like(sp)
        for k in range(8):
            valid = ts[k] > -torch.inf
            slot = torch.where(valid, (sp + off).clamp(max=STACK_DEPTH - 1),
                               STACK_DEPTH)
            stack.scatter_(1, slot.to(torch.int64)[:, None], cs[k][:, None])
            off = off + valid.to(torch.int32)
        sp = sp + off

        # ---- leaf row: inlined triangles, first smallest t wins
        tris = row[:, :9 * leaf_size].reshape(-1, leaf_size, 9)
        h, t, u, vv = moller_trumbore(o[:, None, :], d[:, None, :], tris,
                                      0.0, bt[:, None])
        kmask = (ks[None, :] < lcount[:, None]) & is_leaf[:, None]
        h = h & kmask
        masks = omm[((base + leaf_row.clamp(0, rows - 1)) * leaf_size)
                    [:, None] + ks[None, :]]
        cu = (u * 4.0).to(torch.int32).clamp(0, 3)
        cv = (vv * 4.0).to(torch.int32).clamp(0, 3)
        h = h & (((masks >> (cu * 4 + cv)) & 1) != 0)
        t = torch.where(h, t, torch.inf)
        kk = torch.argmin(t, dim=1)[:, None]
        tk = t.gather(1, kk)[:, 0]
        found = torch.isfinite(tk)
        bp = torch.where(found,
                         leaf_row * leaf_size + kk[:, 0].to(torch.int32), bp)
        bu = torch.where(found, torch.where(h, u, 0.0).gather(1, kk)[:, 0], bu)
        bv = torch.where(found, torch.where(h, vv, 0.0).gather(1, kk)[:, 0],
                         bv)
        bt = torch.where(found, tk, bt)
        if any_hit:
            sp = torch.where(bp >= 0, 0, sp)
        if stats is not None:
            counts += torch.stack([node.sum(), is_leaf.sum(), kmask.sum()])
            node_seen[(base + fetch)[node]] = True
            leaf_seen[(base + fetch)[is_leaf]] = lcount[is_leaf].to(
                torch.int64)

        done = sp == 0
        if bool(done.any()):
            retire(done)
            keep = ~done
            lane, o, d, inv, bt, bp, bu, bv, base, stack, sp = (
                x[keep] for x in (lane, o, d, inv, bt, bp, bu, bv, base,
                                  stack, sp))
    if lane.numel():                                   # cut by MAX_ITERS
        retire(torch.ones_like(lane, dtype=torch.bool))
    if stats is not None:
        counts = counts.tolist() + [int(node_seen.sum()),
                                    int(leaf_seen.sum()), 1,
                                    int(not bool(active.any()))]
        for key, c in zip(("node_rows", "leaf_rows", "leaf_tris",
                           "distinct_node_rows", "distinct_leaf_tris",
                           "calls", "idle_calls"), counts):
            stats[key] = stats.get(key, 0) + c
    return t_out, slot_out, uv_out


def prepare_rays(origins, dirs, t_max, active):
    """Contiguous rays, t_max broadcast to (N,) f32, active (N,) bool
    (all rays when None)."""
    n = origins.shape[0]
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=origins.device)
    if not isinstance(t_max, torch.Tensor):
        with profiling.span("sync"):
            t_max = torch.as_tensor(t_max, dtype=torch.float32,
                                    device=origins.device)
    t_max = t_max.to(origins.device, torch.float32).expand(n).contiguous()
    return origins.contiguous(), dirs.contiguous(), t_max, active.contiguous()


def _check_rays(origins, dirs, t_max, active):
    n = origins.shape[0]
    cuda_lib.check(origins, "origins", torch.float32, (n, 3))
    cuda_lib.check(dirs, "dirs", torch.float32, (n, 3))
    cuda_lib.check(t_max, "t_max", torch.float32, (n,))
    cuda_lib.check(active, "active", torch.bool, (n,))
    dev = dirs.device
    return (n, torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((n, 2), dtype=torch.float32, device=dev))


@cuda_lib.counted("bvh8_trace")
def trace_bvh8(table, leaf_omm, origins, dirs, t_max, active, *,
               leaf_size: int, any_hit: bool):
    """K5: one BVH8 table (R, W) f32, leaf_omm (R*leaf_size,) i32, rays
    origins/dirs (N,3) f32, t_max (N,) f32, active (N,) bool ->
    (t, slot, uv); see the module docstring."""
    if not cuda_lib.on_cuda(table, leaf_omm, origins, dirs, t_max, active):
        return trace_bvh8_plain(table, leaf_omm, origins, dirs, t_max,
                                active, leaf_size=leaf_size, any_hit=any_hit)
    rows, width = table.shape
    cuda_lib.check(table, "table", torch.float32, (rows, None))
    cuda_lib.check(leaf_omm, "leaf_omm", torch.int32, (rows * leaf_size,))
    _require_width(width, leaf_size)
    n, t, slot, uv = _check_rays(origins, dirs, t_max, active)
    if n:
        cuda_lib.bump("bvh8_trace")
        cuda_lib.launch("rtxpt_bvh8_trace", table.data_ptr(), rows, width,
                        leaf_size, leaf_omm.data_ptr(), origins.data_ptr(),
                        dirs.data_ptr(), t_max.data_ptr(), active.data_ptr(),
                        t.data_ptr(), slot.data_ptr(), uv.data_ptr(), n,
                        int(any_hit))
    return t, slot, uv


@cuda_lib.counted("bvh8_trace_sub")
def trace_bvh8_sub(tables, leaf_omm, sub, origins, dirs, t_max, active, *,
                   leaf_size: int, any_hit: bool):
    """K6: K stacked tables (K, S, W) f32, leaf_omm (K, S*leaf_size) i32,
    per-ray subtree sub (N,) i32 (clamped to [0, K)), rays as K5; the slot
    is local to the ray's subtree."""
    if not cuda_lib.on_cuda(tables, leaf_omm, sub, origins, dirs, t_max,
                            active):
        return trace_bvh8_plain(tables, leaf_omm, origins, dirs, t_max,
                                active, sub, leaf_size=leaf_size,
                                any_hit=any_hit)
    k, rows, width = tables.shape
    cuda_lib.check(tables, "tables", torch.float32, (k, rows, width))
    cuda_lib.check(leaf_omm, "leaf_omm", torch.int32, (k, rows * leaf_size))
    _require_width(width, leaf_size)
    n, t, slot, uv = _check_rays(origins, dirs, t_max, active)
    cuda_lib.check(sub, "sub", torch.int32, (n,))
    if n:
        cuda_lib.bump("bvh8_trace_sub")
        cuda_lib.launch("rtxpt_bvh8_trace_sub", tables.data_ptr(), k, rows,
                        width, leaf_size, leaf_omm.data_ptr(), sub.data_ptr(),
                        origins.data_ptr(), dirs.data_ptr(), t_max.data_ptr(),
                        active.data_ptr(), t.data_ptr(), slot.data_ptr(),
                        uv.data_ptr(), n, int(any_hit))
    return t, slot, uv


@cuda_lib.counted("bvh8_trace_2l")
def trace_bvh8_2l(tl, origins, dirs, t_max, active, *, any_hit: bool):
    """The two-level trace of `tl` (a `bvh2l.BVH8TwoLevel`: stacked tables
    (K, S, W) f32, leaf_omm and leaf_tris (K, S*leaf_size) i32, boxes
    (K, 6) f32) in one launch, walking the nearest overlapped subtree
    first when K >= bvh2l.PROBE_MIN_SUBTREES; rays as K5 -> Hit(t, prim,
    uv) with global triangle ids (closest hit) or the occlusion flag (N,)
    bool (any-hit). On CPU tensors, `bvh2l.trace_two_level_plain`, which
    the kernel reproduces bit for bit."""
    from . import bvh2l          # bvh2l imports this module
    if not cuda_lib.on_cuda(tl.sub_tables, tl.sub_leaf_omm, tl.sub_leaf_tris,
                            tl.sub_aabb, origins, dirs, t_max, active):
        return bvh2l.trace_two_level_plain(tl, origins, dirs, t_max, active,
                                           any_hit=any_hit)
    return launch_two_level("rtxpt_bvh8_trace_2l", "bvh8_trace_2l", tl,
                            origins, dirs, t_max, active, any_hit)


def launch_two_level(entry: str, counter: str, tl, origins, dirs, t_max,
                     active, any_hit: bool, *extra):
    """Check a two-level trace's CUDA tensors, allocate its outputs and
    launch C entry point `entry` (``rtxpt_bvh8_trace_2l``, or the lab's
    variant with its mode in `extra`), counting the launch on wrapper
    `counter`; returns what `trace_bvh8_2l` returns."""
    from .bvh2l import PROBE_MIN_SUBTREES
    k, rows, width = tl.sub_tables.shape
    ls = tl.leaf_size
    cuda_lib.check(tl.sub_tables, "sub_tables", torch.float32,
                   (k, rows, width))
    cuda_lib.check(tl.sub_leaf_omm, "sub_leaf_omm", torch.int32,
                   (k, rows * ls))
    cuda_lib.check(tl.sub_leaf_tris, "sub_leaf_tris", torch.int32,
                   (k, rows * ls))
    cuda_lib.check(tl.sub_aabb, "sub_aabb", torch.float32, (k, 6))
    _require_width(width, ls)
    if not 1 <= k <= MAX_SUBTREES:
        raise ValueError(f"{k} subtrees: the kernel takes 1 to "
                         f"{MAX_SUBTREES}")
    n, t, prim, uv = _check_rays(origins, dirs, t_max, active)
    occ = torch.empty((n,), dtype=torch.bool, device=dirs.device)
    next_ray = torch.zeros((1,), dtype=torch.int32, device=dirs.device)
    if n:
        cuda_lib.bump(counter)
        cuda_lib.launch(entry, tl.sub_tables.data_ptr(), k, rows, width, ls,
                        tl.sub_leaf_omm.data_ptr(),
                        tl.sub_leaf_tris.data_ptr(), tl.sub_aabb.data_ptr(),
                        int(k >= PROBE_MIN_SUBTREES), origins.data_ptr(),
                        dirs.data_ptr(), t_max.data_ptr(), active.data_ptr(),
                        t.data_ptr(), prim.data_ptr(), uv.data_ptr(),
                        occ.data_ptr(), next_ray.data_ptr(), n, int(any_hit),
                        *extra)
    return occ if any_hit else Hit(t, prim, uv)


def _require_width(width: int, leaf_size: int):
    """Rows hold max(56, 9*leaf_size) floats; the kernel reads node rows
    as 16-byte vectors, so the width must be a multiple of 4 (it is 144
    at the builds' leaf size, bvh.LEAF_SIZE = 16)."""
    if not 1 <= leaf_size <= LEAF_MAX or width < max(56, 9 * leaf_size) \
            or width % 4:
        raise ValueError(f"table width {width} and leaf_size {leaf_size}: "
                         "rows need max(56, 9*leaf_size) floats, a multiple "
                         "of 4")
