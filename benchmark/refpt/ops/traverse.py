"""The reference's own trace: brute force over triangle clusters.

Replaces the port's trace dispatch in this frozen copy. The triangles are
grouped into clusters of `CLUSTER` by the Morton code of their centroids,
only to skip the clusters whose box a ray cannot enter; every triangle of
every entered cluster is tested, so each hit is worked out again from the
scene's triangles whatever acceleration structure the port built. The
test is the two-sided, sign-folded Möller–Trumbore of the port's plain
dense trace, and the winner's t and (u, v) are solved once more from its
triangle, as the port resolves its hits. Equal t goes to the lowest
triangle id.

`round_to` (the control of the correctness check) rounds every ray and
hit that passes through here to a lower precision.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .intersect import Hit, safe_inv

CLUSTER = 128
LANE_CHUNK = 4096
PAIR_CHUNK = 16384


@dataclass
class Clusters:
    tri9: torch.Tensor      # (NC*CLUSTER, 9) p0, e1, e2 by cluster slot
    prim: torch.Tensor      # (NC*CLUSTER,) i64 triangle id (-1: padding)
    box: torch.Tensor       # (NC, 6) min xyz, max xyz
    center: torch.Tensor    # (3,) the scene box's centre
    slot_of: torch.Tensor   # (T,) i64 each triangle's row in tri9
    round_to: Optional[torch.dtype] = None


def _morton(q):
    q = q.astype(np.int64)

    def part(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249
    return part(q[:, 0]) | (part(q[:, 1]) << 1) | (part(q[:, 2]) << 2)


def build_clusters(positions, indices, device) -> Clusters:
    """Clusters of the (V,3) float32 positions' (T,3) triangles, with the
    triangles' corners taken about the scene box's centre."""
    pos = np.asarray(positions, np.float32)
    idx = np.asarray(indices, np.int64)
    lo, hi = pos.min(0), pos.max(0)
    center = ((lo + hi) * np.float32(0.5)).astype(np.float32)
    p = pos - center
    p0, p1, p2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
    cen = (p0 + p1 + p2) / np.float32(3.0)
    q = np.clip((cen - (lo - center)) / np.maximum(hi - lo, 1e-20) * 1023.0,
                0, 1023)
    order = np.argsort(_morton(q), kind="stable")
    t = idx.shape[0]
    nc = -(-t // CLUSTER)
    tri9 = np.zeros((nc * CLUSTER, 9), np.float32)
    prim = np.full((nc * CLUSTER,), -1, np.int64)
    tri9[:t, 0:3] = p0[order]
    tri9[:t, 3:6] = p1[order] - p0[order]
    tri9[:t, 6:9] = p2[order] - p0[order]
    prim[:t] = order
    corners = np.stack([p0[order], p1[order], p2[order]], 1)
    cmin = np.full((nc * CLUSTER, 3), np.inf, np.float32)
    cmax = np.full((nc * CLUSTER, 3), -np.inf, np.float32)
    cmin[:t], cmax[:t] = corners.min(1), corners.max(1)
    box = np.concatenate([cmin.reshape(nc, CLUSTER, 3).min(1),
                          cmax.reshape(nc, CLUSTER, 3).max(1)], 1)
    slot_of = np.empty((t,), np.int64)
    slot_of[order] = np.arange(t)
    f = lambda a: torch.as_tensor(a, device=device)
    return Clusters(f(tri9), f(prim), f(box), f(center), f(slot_of))


def _rounded(cl: Clusters, *ts):
    if cl.round_to is None:
        return ts
    return tuple(x.to(cl.round_to).to(torch.float32) for x in ts)


def _candidates(cl: Clusters, o, inv, t_max):
    """(lane, cluster) pairs whose slab interval is not empty in [0, t_max]."""
    b = cl.box
    t0 = (b[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (b[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    tn = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    tf = torch.minimum(torch.maximum(t0, t1).amin(-1), t_max[:, None])
    return torch.nonzero(tn <= tf)


def _test(cl: Clusters, o, d, lanes, clus, t_max):
    """Möller–Trumbore of each pair's lane against its cluster's rows:
    (PAIRS, CLUSTER) hit t, inf where missed."""
    rows = clus[:, None] * CLUSTER + torch.arange(CLUSTER, device=o.device)
    tr = cl.tri9[rows]
    lo, ld = o[lanes][:, None, :], d[lanes][:, None, :]
    p0, e1, e2 = tr[..., 0:3], tr[..., 3:6], tr[..., 6:9]
    ux, uy, uz = ld[..., 0], ld[..., 1], ld[..., 2]
    hx = uy * e2[..., 2] - uz * e2[..., 1]
    hy = uz * e2[..., 0] - ux * e2[..., 2]
    hz = ux * e2[..., 1] - uy * e2[..., 0]
    a = e1[..., 0] * hx + e1[..., 1] * hy + e1[..., 2] * hz
    s = lo - p0
    uu = s[..., 0] * hx + s[..., 1] * hy + s[..., 2] * hz
    qx = s[..., 1] * e1[..., 2] - s[..., 2] * e1[..., 1]
    qy = s[..., 2] * e1[..., 0] - s[..., 0] * e1[..., 2]
    qz = s[..., 0] * e1[..., 1] - s[..., 1] * e1[..., 0]
    vv = ux * qx + uy * qy + uz * qz
    tt = e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz
    neg = a < 0.0
    absa = torch.where(neg, -a, a)
    su = torch.where(neg, -uu, uu)
    sv = torch.where(neg, -vv, vv)
    st = torch.where(neg, -tt, tt)
    t_hit = st / absa
    ok = ((absa > 1e-12) & (su >= 0.0) & (sv >= 0.0) & (su + sv <= absa)
          & (st > 0.0) & (t_hit < t_max[lanes][:, None]))
    return torch.where(ok, t_hit, torch.inf), rows


def _winners(cl: Clusters, o, d, t_max, active):
    """Per lane the closest hit's (t, triangle id): t_max and -1 where none."""
    n = o.shape[0]
    big = torch.iinfo(torch.int64).max
    best_t = t_max.clone()
    best_p = torch.full((n,), big, dtype=torch.int64, device=o.device)
    lanes_all = torch.nonzero(active)[:, 0]
    inv = torch.stack([safe_inv(d[:, 0]), safe_inv(d[:, 1]),
                       safe_inv(d[:, 2])], -1)
    for s in range(0, lanes_all.numel(), LANE_CHUNK):
        lanes_c = lanes_all[s:s + LANE_CHUNK]
        pairs = _candidates(cl, o[lanes_c], inv[lanes_c], t_max[lanes_c])
        for p in range(0, pairs.shape[0], PAIR_CHUNK):
            pr = pairs[p:p + PAIR_CHUNK]
            lanes = lanes_c[pr[:, 0]]
            t_hit, rows = _test(cl, o, d, lanes, pr[:, 1], t_max)
            tmin = t_hit.amin(1)
            pid = torch.where(t_hit == tmin[:, None], cl.prim[rows],
                              big).amin(1)
            got = tmin < torch.inf
            lanes, tmin, pid = lanes[got], tmin[got], pid[got]
            new_t = best_t.clone()
            new_t.scatter_reduce_(0, lanes, tmin, "amin")
            best_p = torch.where(new_t < best_t, big, best_p)
            win = tmin == new_t[lanes]
            best_p.scatter_reduce_(0, lanes[win], pid[win], "amin")
            best_t = new_t
    return best_t, torch.where(best_p == big, -1, best_p)


def _prepare(cl: Clusters, origins, dirs, t_max, active):
    n = origins.shape[0]
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=origins.device)
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=origins.device).expand(n).contiguous()
    o, d = _rounded(cl, origins, dirs)
    return o - cl.center, d, t_max, active


def trace_closest(cl: Clusters, origins, dirs, t_max=1e30,
                  active=None) -> Hit:
    """Closest hit in (0, t_max), with t and (u, v) solved from the
    winning triangle."""
    o, d, tm, act = _prepare(cl, origins, dirs, t_max, active)
    t_q, prim = _winners(cl, o, d, tm, act)
    found = prim >= 0
    tri = cl.tri9[cl.slot_of[torch.clamp(prim, min=0)]]
    p0, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
    h = torch.linalg.cross(d, e2, dim=-1)
    a = torch.sum(e1 * h, dim=-1)
    tiny = torch.where(a < 0, -1e-30, 1e-30)
    f = 1.0 / torch.where(torch.abs(a) < 1e-30, tiny, a)
    s = o - p0
    u = f * torch.sum(s * h, dim=-1)
    q = torch.linalg.cross(s, e1, dim=-1)
    v = f * torch.sum(d * q, dim=-1)
    t_e = f * torch.sum(e2 * q, dim=-1)
    t = torch.where(found, t_e, t_q)
    uv = torch.where(found[..., None], torch.stack([u, v], dim=-1), 0.0)
    t, uv = _rounded(cl, t, uv)
    return Hit(t, torch.where(found, prim, -1).to(torch.int32), uv)


def trace_anyhit(cl: Clusters, origins, dirs, t_max=1e30, active=None):
    """True where the segment (0, t_max) is occluded."""
    o, d, tm, act = _prepare(cl, origins, dirs, t_max, active)
    return _winners(cl, o, d, tm, act)[1] >= 0
