"""Dense closest/any-hit ray-triangle trace for scenes of at most
MAX_TRIS triangles (counterpart of rtxpt_tpu/ops/mt_dense.py).

Triangles are morton-ordered and chunked into clusters of CLUSTER rows of
the recentered (p0, e1, e2) table `tri9` (column 9: original triangle
id). The trace kernel K1 (``csrc/mt_dense.cu``) runs one thread per ray:
it walks the clusters in order, slab-gates each cluster AABB against the
lane's running closest t, and runs Möller–Trumbore on the cluster's rows.
The TPU expressed the same test as a W(RC,16) @ x(16,TILE) matmul over
[o (x) d, d, o, 1] features and picked winners on a quantized t; the port
tests triangles directly and selects exactly: smallest t, ties to the
lowest slot. `trace_closest` then re-solves t/u/v from the winning
triangle in float32, as the reference does.

Origins are recentered on the scene center before the trace (precision of
the products with far-away origins), as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda_lib
from .intersect import Hit

CLUSTER = 64            # triangles per cluster (csrc/mt_dense.cu kCluster)
MAX_TRIS = 8192         # beyond this the reference switches to BVH paths
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


def build_dense(positions, indices, device="cpu") -> DenseMT:
    aabb, tri9, center, nc = build_dense_np(positions, indices)
    t = lambda a: torch.as_tensor(a, device=device)
    return DenseMT(aabb=t(aabb), tri9=t(tri9), center=t(center),
                   num_clusters=nc)


def _safe_inv(c):
    tiny = torch.where(c < 0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(c) < 1e-12, tiny, c)


def _trace_plain_chunk(aabb_c, tri9, o, d, t_max, active, any_hit):
    """K1's arithmetic on one chunk of rays, cluster by cluster. Only the
    lanes that pass a cluster's slab gate are tested against its rows."""
    n = o.shape[0]
    nc = aabb_c.shape[0]
    best = t_max.clone()
    slot = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    ix, iy, iz = _safe_inv(d[:, 0]), _safe_inv(d[:, 1]), _safe_inv(d[:, 2])
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    rows = torch.arange(CLUSTER, device=o.device, dtype=torch.int32)
    box = aabb_c.tolist()
    tris = tri9[:, 0:9].reshape(nc, CLUSTER, 9)
    for c in range(nc):
        live = active & (slot < 0) if any_hit else active
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
                      any_hit: bool):
    """Plain version of K1 (chunked over rays)."""
    ts, slots = [], []
    for s in range(0, origins_c.shape[0], _PLAIN_CHUNK):
        sl = slice(s, s + _PLAIN_CHUNK)
        t, slot = _trace_plain_chunk(aabb_c, tri9, origins_c[sl], dirs[sl],
                                     t_max[sl], active[sl], any_hit)
        ts.append(t)
        slots.append(slot)
    if not ts:
        return (torch.empty_like(t_max),
                torch.empty((0,), dtype=torch.int32, device=t_max.device))
    return torch.cat(ts), torch.cat(slots)


@cuda_lib.counted("mt_dense")
def trace_dense(aabb_c, tri9, origins_c, dirs, t_max, active,
                any_hit: bool):
    """K1: recentered cluster AABBs (NC,6), tri9 (NC*CLUSTER,10),
    recentered origins (N,3), directions (N,3), t_max (N,), active (N,)
    bool -> (t (N,) f32, slot (N,) i32). slot is the winning tri9 row
    (-1: no hit) and t its distance (t_max where none); any_hit stops at
    the first hit in slot order."""
    if not cuda_lib.on_cuda(aabb_c, tri9, origins_c, dirs, t_max, active):
        return trace_dense_plain(aabb_c, tri9, origins_c, dirs, t_max,
                                 active, any_hit)
    n = origins_c.shape[0]
    nc = aabb_c.shape[0]
    cuda_lib.check(aabb_c, "aabb_c", torch.float32, (nc, 6))
    cuda_lib.check(tri9, "tri9", torch.float32, (nc * CLUSTER, 10))
    cuda_lib.check(origins_c, "origins_c", torch.float32, (n, 3))
    cuda_lib.check(dirs, "dirs", torch.float32, (n, 3))
    cuda_lib.check(t_max, "t_max", torch.float32, (n,))
    cuda_lib.check(active, "active", torch.bool, (n,))
    t = torch.empty((n,), dtype=torch.float32, device=dirs.device)
    slot = torch.empty((n,), dtype=torch.int32, device=dirs.device)
    if n:
        cuda_lib.bump("mt_dense")
        cuda_lib.launch("rtxpt_mt_dense", aabb_c.data_ptr(), tri9.data_ptr(),
                        nc, origins_c.data_ptr(), dirs.data_ptr(),
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
