"""Dense closest/any-hit ray-triangle trace for scenes of at most
MAX_TRIS triangles (counterpart of rtxpt_tpu/ops/mt_dense.py).

Triangles are morton-ordered and chunked into clusters of CLUSTER rows of
the recentered (p0, e1, e2) table `tri9` (column 9: original triangle
id). Before each trace, the prepass K7 (``csrc/mt_dense.cu``
`rtxpt_tile_keys`) builds a worklist per tile of TILE lanes: the clusters
that some active lane of the tile can enter, nearest slab entry first
(`tile_worklists`). The trace kernel K1 runs one thread per ray and one
block per tile: it walks its tile's worklist, slab-gates each cluster
AABB against the lane's running closest t, and runs Möller–Trumbore on
the cluster's rows. The TPU expressed the same test as a W(RC,16) @
x(16,TILE) matmul over [o (x) d, d, o, 1] features and picked winners on
a quantized t; the port tests triangles directly and selects exactly:
smallest t, ties to the lowest slot, whatever the visit order.
`trace_closest` then re-solves t/u/v from the winning triangle in
float32, as the reference does.

Origins are recentered on the scene center before the trace (precision of
the products with far-away origins), as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda_lib
from .intersect import Hit, safe_inv

CLUSTER = 64            # triangles per cluster (csrc/mt_dense.cu kCluster)
MAX_TRIS = 8192         # beyond this the reference switches to BVH paths
TILE = 128              # lanes per K1 block and worklist (kBlock)
_PLAIN_CHUNK = 1 << 16  # rays per step of the plain version


def _round_up(x, m):
    return (x + m - 1) // m * m


def _morton3(q: np.ndarray) -> np.ndarray:
    """(N,3) uint32 10-bit coords -> interleaved 30-bit morton codes."""
    def part(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x
    return (part(q[:, 0]) | (part(q[:, 1]) << np.uint64(1))
            | (part(q[:, 2]) << np.uint64(2)))


@dataclasses.dataclass
class DenseMT:
    aabb: torch.Tensor        # (NC,6) f32 cluster min.xyz max.xyz (world)
    tri9: torch.Tensor        # (NC*CLUSTER,10) f32 recentered p0,e1,e2,id
    center: torch.Tensor      # (3,) f32 recenter point
    num_clusters: int

    @property
    def aabb_c(self) -> torch.Tensor:
        """Cluster AABBs in the recentered frame of the trace."""
        return (self.aabb - torch.cat([self.center, self.center])[None]
                ).contiguous()


def supported(n_tris: int) -> bool:
    return n_tris <= MAX_TRIS


def build_dense_np(positions, indices):
    """Host build -> (aabb, tri9, center, num_clusters) numpy, identical
    to the reference's `build_dense` tables."""
    p = np.asarray(positions, np.float64)
    idx = np.asarray(indices, np.int64)
    t = idx.shape[0]
    center = (p.min(0) + p.max(0)) * 0.5
    # spatial (morton) triangle order -> tight cluster AABBs
    cent = (p[idx[:, 0]] + p[idx[:, 1]] + p[idx[:, 2]]) / 3.0
    lo, hi = cent.min(0), cent.max(0)
    q = np.clip((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023.0,
                0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(q), kind="stable")
    nc = max(_round_up(t, CLUSTER) // CLUSTER, 1)
    p0a = (p[idx[:, 0]] - center)[order]          # (T,3) recentered
    e1a = (p[idx[:, 1]] - p[idx[:, 0]])[order]
    e2a = (p[idx[:, 2]] - p[idx[:, 0]])[order]
    pts = np.stack([p0a, p0a + e1a, p0a + e2a], 1) + center  # (T,3,3)
    t_pad = nc * CLUSTER
    pts_pad = np.concatenate(
        [pts, np.repeat(pts[-1:], t_pad - t, axis=0)], 0)
    pc = pts_pad.reshape(nc, CLUSTER * 3, 3)
    aabb = np.concatenate([pc.min(1), pc.max(1)], -1).astype(np.float32)
    # padding slots: zero edges (never hit), id -1
    tri9 = np.full((t_pad, 10), -1.0, np.float32)
    tri9[:, 0:9] = 0.0
    slot = np.arange(t)
    tri9[slot, 0:3] = p0a
    tri9[slot, 3:6] = e1a
    tri9[slot, 6:9] = e2a
    tri9[slot, 9] = order.astype(np.float32)
    return aabb, tri9, center.astype(np.float32), nc


def build_dense(positions, indices, device="cuda") -> DenseMT:
    aabb, tri9, center, nc = build_dense_np(positions, indices)
    t = lambda a: torch.as_tensor(a, device=device)
    return DenseMT(aabb=t(aabb), tri9=t(tri9), center=t(center),
                   num_clusters=nc)


def _pad_lanes(origins, dirs, t_max, active, tile: int):
    """Lanes padded to a multiple of `tile` as the reference's
    `_trace_dense` pads them: origin 0, direction 1, t_max 0, inactive."""
    pad = -origins.shape[0] % tile
    if pad == 0:
        return origins, dirs, t_max, active
    z = lambda a, v: torch.cat([a, torch.full((pad,) + a.shape[1:], v,
                                              dtype=a.dtype,
                                              device=a.device)])
    return z(origins, 0.0), z(dirs, 1.0), z(t_max, 0.0), z(active, False)


def tile_keys_plain(aabb, origins, dirs, t_max, active, tile: int = TILE):
    """Plain version of K7 (the reference's `_tile_worklists_exact` keys):
    cluster AABBs (NC,6), origins and directions (N,3), t_max (N,), active
    (N,) bool -> keys (ceil(N/tile), NC) f32. A key is the smallest slab
    entry t (not clamped at 0: negative for an origin inside the box) over
    the tile's active lanes whose slab test max(tn, 0) <= min(tf, t_max)
    passes, +inf where none does; -0.0 entries count as +0.0."""
    o, d, tm, act = _pad_lanes(origins, dirs, t_max, active, tile)
    inv = safe_inv(d)
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    ix, iy, iz = (inv[:, k].contiguous() for k in range(3))
    keys = torch.empty((o.shape[0] // tile, aabb.shape[0]),
                       dtype=torch.float32, device=aabb.device)
    for c, b in enumerate(aabb.tolist()):
        t0x, t1x = (b[0] - ox) * ix, (b[3] - ox) * ix
        t0y, t1y = (b[1] - oy) * iy, (b[4] - oy) * iy
        t0z, t1z = (b[2] - oz) * iz, (b[5] - oz) * iz
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.minimum(torch.maximum(t0z, t1z), tm))
        hit = (torch.clamp(tn, min=0.0) <= tf) & act
        keys[:, c] = torch.where(hit, tn + 0.0, torch.inf).reshape(
            -1, tile).amin(1)
    return keys


@cuda_lib.counted("tile_keys")
def tile_keys(aabb, origins, dirs, t_max, active, tile: int = TILE):
    """K7: (keys, counts, order): the keys of `tile_keys_plain` and the
    worklists `worklists_from_keys` makes of them, one block per tile
    (`tile` a multiple of 32, at most 1024; at most MAX_TRIS / CLUSTER
    clusters)."""
    if not cuda_lib.on_cuda(aabb, origins, dirs, t_max, active):
        keys = tile_keys_plain(aabb, origins, dirs, t_max, active, tile)
        return (keys, *worklists_from_keys(keys))
    n, nc = origins.shape[0], aabb.shape[0]
    cuda_lib.check(aabb, "aabb", torch.float32, (nc, 6))
    cuda_lib.check(origins, "origins", torch.float32, (n, 3))
    cuda_lib.check(dirs, "dirs", torch.float32, (n, 3))
    cuda_lib.check(t_max, "t_max", torch.float32, (n,))
    cuda_lib.check(active, "active", torch.bool, (n,))
    if not 1 <= nc <= MAX_TRIS // CLUSTER:
        raise ValueError(f"tile_keys: {nc} clusters, at most "
                         f"{MAX_TRIS // CLUSTER}")
    if tile % 32 or not 32 <= tile <= 1024:
        raise ValueError(f"tile_keys: tile {tile} is not a multiple of 32 "
                         "in [32, 1024]")
    tiles = (n + tile - 1) // tile
    keys = torch.empty((tiles, nc), dtype=torch.float32, device=aabb.device)
    counts = torch.empty((tiles,), dtype=torch.int32, device=aabb.device)
    order = torch.empty((tiles, nc), dtype=torch.int32, device=aabb.device)
    if n:
        cuda_lib.bump("tile_keys")
        cuda_lib.launch("rtxpt_tile_keys", aabb.data_ptr(), nc,
                        origins.data_ptr(), dirs.data_ptr(), t_max.data_ptr(),
                        active.data_ptr(), keys.data_ptr(), counts.data_ptr(),
                        order.data_ptr(), n, tile)
    return keys, counts, order


def worklists_from_keys(keys):
    """(counts (T,) i32, order (T, NC) i32) from K7's keys: a tile's
    clusters with a finite key, nearest entry first (stable argsort, as
    the reference's jnp.argsort; K7 sorts in the kernel)."""
    counts = torch.isfinite(keys).sum(1).to(torch.int32)
    order = torch.argsort(keys, dim=1, stable=True).to(torch.int32)
    return counts, order


def tile_worklists(aabb, origins, dirs, t_max, active, tile: int = TILE):
    """Per-tile near-to-far cluster worklists (counts, order) of the
    reference's exact prepass (`_tile_worklists_exact`, fused form
    `_tile_worklists_pallas`) for tiles of `tile` lanes."""
    return tile_keys(aabb, origins, dirs, t_max, active, tile)[1:]


def worklist_mask(worklists):
    """(T, NC) bool: cluster c is on tile t's worklist (counts, order)."""
    counts, order = worklists
    rank = torch.arange(order.shape[1], device=order.device)[None, :]
    return torch.zeros(order.shape, dtype=torch.bool,
                       device=order.device).scatter_(
        1, order.long(), rank < counts[:, None])


def tile_worklists_interval(aabb, origins, dirs, t_max, active,
                            tile: int = TILE):
    """The reference's conservative prepass (`_tile_worklists_interval`,
    plain only): each tile reduced to its active lanes' origin box,
    direction interval and largest t_max, slab-tested per (tile, cluster)
    in interval arithmetic; ordered by entry t plus the distance from the
    tile's origin centroid to the cluster center. A superset of
    `tile_worklists`; the dense-trace lab compares the two."""
    o, d, tm, act = _pad_lanes(origins, dirs, t_max, active, tile)
    t = o.shape[0] // tile
    big = 1e30
    o_t, d_t = o.reshape(t, tile, 3), d.reshape(t, tile, 3)
    tm_t = tm.reshape(t, tile)
    ac = act.reshape(t, tile)[..., None]
    o_lo = torch.where(ac, o_t, big).amin(1)               # (T,3)
    o_hi = torch.where(ac, o_t, -big).amax(1)
    d_lo = torch.where(ac, d_t, big).amin(1)
    d_hi = torch.where(ac, d_t, -big).amax(1)
    tmx = torch.where(ac[..., 0], tm_t, 0.0).amax(1)       # (T,)
    any_act = ac[..., 0].any(1)
    lo, hi = aabb[None, :, 0:3], aabb[None, :, 3:6]        # (1,NC,3)
    nl_lo, nl_hi = lo - o_hi[:, None], lo - o_lo[:, None]  # (T,NC,3)
    nh_lo, nh_hi = hi - o_hi[:, None], hi - o_lo[:, None]
    dl, dh = d_lo[:, None], d_hi[:, None]                  # (T,1,3)
    sign_def = (dl > 1e-12) | (dh < -1e-12)
    dl_s = torch.where(torch.abs(dl) < 1e-12, 1e-12, dl)
    dh_s = torch.where(torch.abs(dh) < 1e-12, 1e-12, dh)

    def qmin(num_lo, num_hi):
        return torch.minimum(torch.minimum(num_lo / dl_s, num_lo / dh_s),
                             torch.minimum(num_hi / dl_s, num_hi / dh_s))

    def qmax(num_lo, num_hi):
        return torch.maximum(torch.maximum(num_lo / dl_s, num_lo / dh_s),
                             torch.maximum(num_hi / dl_s, num_hi / dh_s))

    # a zero-spanning direction interval puts no bound on its axis
    ax_lo = torch.where(sign_def, torch.minimum(qmin(nl_lo, nl_hi),
                                                qmin(nh_lo, nh_hi)), -big)
    ax_hi = torch.where(sign_def, torch.maximum(qmax(nl_lo, nl_hi),
                                                qmax(nh_lo, nh_hi)), big)
    tn, tf = ax_lo.amax(-1), ax_hi.amin(-1)                # (T,NC)
    hit = (torch.clamp(tn, min=0.0) <= torch.minimum(tf, tmx[:, None])) \
        & any_act[:, None]
    o_c = torch.where(any_act[:, None], 0.5 * (o_lo + o_hi), 0.0)
    c_c = 0.5 * (aabb[:, 0:3] + aabb[:, 3:6])
    v = c_c[None, :, :] - o_c[:, None, :]
    dist = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])
    key = torch.where(hit, torch.clamp(tn, min=0.0) + dist, torch.inf)
    return (hit.sum(1).to(torch.int32),
            torch.argsort(key, dim=1, stable=True).to(torch.int32))


def _trace_plain_chunk(aabb_c, tri9, o, d, t_max, active, any_hit,
                       member=None):
    """K1's arithmetic on one chunk of rays, cluster by cluster in slot
    order. Only the lanes that pass a cluster's slab gate (and, with
    `member` (NC, n) bool, have it on their tile's worklist) are tested
    against its rows."""
    n = o.shape[0]
    nc = aabb_c.shape[0]
    best = t_max.clone()
    slot = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    ix, iy, iz = safe_inv(d[:, 0]), safe_inv(d[:, 1]), safe_inv(d[:, 2])
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    rows = torch.arange(CLUSTER, device=o.device, dtype=torch.int32)
    box = aabb_c.tolist()
    tris = tri9[:, 0:9].reshape(nc, CLUSTER, 9)
    for c in range(nc):
        live = active & (slot < 0) if any_hit else active
        if member is not None:
            live = live & member[c]
        b = box[c]
        t0x, t1x = (b[0] - ox) * ix, (b[3] - ox) * ix
        t0y, t1y = (b[1] - oy) * iy, (b[4] - oy) * iy
        t0z, t1z = (b[2] - oz) * iz, (b[5] - oz) * iz
        lim = t_max if any_hit else best
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.clamp(torch.minimum(t0z, t1z), min=0.0))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.minimum(torch.maximum(t0z, t1z), lim))
        lanes = torch.nonzero(live & (tn <= tf))[:, 0]
        if lanes.numel() == 0:
            continue
        tr = tris[c]
        p0x, p0y, p0z = tr[None, :, 0], tr[None, :, 1], tr[None, :, 2]
        e1x, e1y, e1z = tr[None, :, 3], tr[None, :, 4], tr[None, :, 5]
        e2x, e2y, e2z = tr[None, :, 6], tr[None, :, 7], tr[None, :, 8]
        lx, ly, lz = ox[lanes, None], oy[lanes, None], oz[lanes, None]
        ux, uy, uz = dx[lanes, None], dy[lanes, None], dz[lanes, None]
        # Möller–Trumbore, sign-folded by a (two-sided)
        hx = uy * e2z - uz * e2y
        hy = uz * e2x - ux * e2z
        hz = ux * e2y - uy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        sx, sy, sz = lx - p0x, ly - p0y, lz - p0z
        uu = sx * hx + sy * hy + sz * hz
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        vv = ux * qx + uy * qy + uz * qz
        tt = e2x * qx + e2y * qy + e2z * qz
        neg = a < 0.0
        absa = torch.where(neg, -a, a)
        su = torch.where(neg, -uu, uu)
        sv = torch.where(neg, -vv, vv)
        st = torch.where(neg, -tt, tt)
        t_hit = st / absa
        ok = ((absa > 1e-12) & (su >= 0.0) & (sv >= 0.0)
              & (su + sv <= absa) & (st > 0.0)
              & (t_hit < (t_max if any_hit else best)[lanes, None]))
        t_hit = torch.where(ok, t_hit, torch.inf)
        if any_hit:
            first = torch.where(ok, rows[None, :], CLUSTER).amin(1)
            got = first < CLUSTER
            row = torch.clamp(first, max=CLUSTER - 1)
            t_row = torch.gather(t_hit, 1, row[:, None].long())[:, 0]
        else:
            t_row = t_hit.amin(1)
            got = t_row < torch.inf
            row = torch.where(ok & (t_hit == t_row[:, None]), rows[None, :],
                              CLUSTER).amin(1)
        upd = lanes[got]
        best[upd] = t_row[got]
        slot[upd] = c * CLUSTER + row[got]
    return best, slot


def trace_dense_plain(aabb_c, tri9, origins_c, dirs, t_max, active,
                      any_hit: bool, worklists=None, tile: int = TILE):
    """Plain version of K1 (chunked over rays). With `worklists` =
    (counts, order) of tiles of `tile` lanes, a lane tests cluster c only
    if c is among its tile's first counts entries; the winners are those
    of the call without worklists, since a tile's list holds every cluster
    whose slab gate one of its lanes can pass."""
    n = origins_c.shape[0]
    member = None if worklists is None else worklist_mask(worklists)
    ts, slots = [], []
    for s in range(0, n, _PLAIN_CHUNK):
        sl = slice(s, s + _PLAIN_CHUNK)
        m = None if member is None else member[
            torch.arange(s, min(s + _PLAIN_CHUNK, n),
                         device=aabb_c.device) // tile].T.contiguous()
        t, slot = _trace_plain_chunk(aabb_c, tri9, origins_c[sl], dirs[sl],
                                     t_max[sl], active[sl], any_hit, m)
        ts.append(t)
        slots.append(slot)
    if not ts:
        return (torch.empty_like(t_max),
                torch.empty((0,), dtype=torch.int32, device=t_max.device))
    return torch.cat(ts), torch.cat(slots)


@cuda_lib.counted("mt_dense")
def trace_dense(aabb_c, tri9, origins_c, dirs, t_max, active,
                any_hit: bool, worklists=None):
    """K1: recentered cluster AABBs (NC,6), tri9 (NC*CLUSTER,10),
    recentered origins (N,3), directions (N,3), t_max (N,), active (N,)
    bool -> (t (N,) f32, slot (N,) i32). slot is the winning tri9 row
    (-1: no hit) and t its distance (t_max where none); any_hit stops at
    the first hit it finds. The tiles' worklists (`worklists`: those
    tile_worklists() gives for these inputs, built here when None) come
    from K7 on the same recentered inputs, so every (lane, cluster) pair
    K1's gate lets through is on its tile's list."""
    cuda = cuda_lib.on_cuda(aabb_c, tri9, origins_c, dirs, t_max, active)
    if worklists is None:
        worklists = tile_worklists(aabb_c, origins_c, dirs, t_max, active)
    counts, order = worklists
    if not cuda:
        return trace_dense_plain(aabb_c, tri9, origins_c, dirs, t_max,
                                 active, any_hit, (counts, order))
    n = origins_c.shape[0]
    nc = aabb_c.shape[0]
    cuda_lib.check(aabb_c, "aabb_c", torch.float32, (nc, 6))
    cuda_lib.check(tri9, "tri9", torch.float32, (nc * CLUSTER, 10))
    cuda_lib.check(origins_c, "origins_c", torch.float32, (n, 3))
    cuda_lib.check(dirs, "dirs", torch.float32, (n, 3))
    cuda_lib.check(t_max, "t_max", torch.float32, (n,))
    cuda_lib.check(active, "active", torch.bool, (n,))
    tiles = (n + TILE - 1) // TILE
    cuda_lib.check(counts, "counts", torch.int32, (tiles,))
    cuda_lib.check(order, "order", torch.int32, (tiles, nc))
    t = torch.empty((n,), dtype=torch.float32, device=dirs.device)
    slot = torch.empty((n,), dtype=torch.int32, device=dirs.device)
    if n:
        cuda_lib.bump("mt_dense")
        cuda_lib.launch("rtxpt_mt_dense", aabb_c.data_ptr(), tri9.data_ptr(),
                        nc, counts.data_ptr(), order.data_ptr(),
                        origins_c.data_ptr(), dirs.data_ptr(),
                        t_max.data_ptr(), active.data_ptr(), t.data_ptr(),
                        slot.data_ptr(), n, int(any_hit))
    return t, slot


def _prepare(dmt: DenseMT, origins, dirs, t_max, active):
    n = origins.shape[0]
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=origins.device)
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=origins.device).expand(n).contiguous()
    o_c = (origins - dmt.center[None, :]).contiguous()
    return o_c, dirs.contiguous(), t_max, active.contiguous()


def resolve_hits(dmt: DenseMT, origins_c, dirs, t_q, slot) -> Hit:
    """Exact t/u/v and the original triangle id of each lane's winning
    tri9 row (one float32 Möller–Trumbore solve per lane, as in the
    reference); lanes without a winner keep t_q and report prim -1."""
    from . import gather
    found = slot >= 0
    tri9 = gather.gather_rows(dmt.tri9, torch.clamp(slot, min=0))
    p0 = tri9[..., 0:3]
    e1 = tri9[..., 3:6]
    e2 = tri9[..., 6:9]
    h = torch.linalg.cross(dirs, e2, dim=-1)
    a = torch.sum(e1 * h, dim=-1)
    tiny = torch.where(a < 0, -1e-30, 1e-30)
    f = 1.0 / torch.where(torch.abs(a) < 1e-30, tiny, a)
    s = origins_c - p0
    u = f * torch.sum(s * h, dim=-1)
    q = torch.linalg.cross(s, e1, dim=-1)
    v = f * torch.sum(dirs * q, dim=-1)
    t_e = f * torch.sum(e2 * q, dim=-1)
    t = torch.where(found, t_e, t_q)
    uv = torch.where(found[..., None], torch.stack([u, v], dim=-1), 0.0)
    prim = torch.where(found, torch.round(tri9[..., 9]).to(torch.int32), -1)
    return Hit(t, prim, uv)


def trace_closest(dmt: DenseMT, origins, dirs, t_max=1e30,
                  active=None) -> Hit:
    """Closest hit in (0, t_max) with exact t/u/v re-solved from the
    winning triangle. (The reference's dense trace also accepts a t_min
    that its kernel ignores: it always tests t > 0.)"""
    o_c, d, tm, act = _prepare(dmt, origins, dirs, t_max, active)
    t_q, slot = trace_dense(dmt.aabb_c, dmt.tri9, o_c, d, tm, act,
                            any_hit=False)
    return resolve_hits(dmt, o_c, d, t_q, slot)


def trace_anyhit(dmt: DenseMT, origins, dirs, t_max=1e30, active=None):
    """True where the segment (0, t_max) is occluded."""
    o_c, d, tm, act = _prepare(dmt, origins, dirs, t_max, active)
    _, slot = trace_dense(dmt.aabb_c, dmt.tri9, o_c, d, tm, act,
                          any_hit=True)
    return slot >= 0
