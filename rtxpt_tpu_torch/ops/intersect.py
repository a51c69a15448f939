"""Hit record and ray-primitive tests (counterpart of
rtxpt_tpu/ops/intersect.py and the `_safe_inv` of rtxpt_tpu/ops/traverse.py).

Plain tensor functions; the trace kernels (``csrc/*.cu``) evaluate the same
float32 operations in the same order."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Hit(NamedTuple):
    """Closest-hit record, SoA over rays (HitInfo.hlsli)."""
    t: torch.Tensor        # (N,) f32 hit distance (t_max if miss)
    prim: torch.Tensor     # (N,) i32 original triangle id (-1 = miss)
    bary: torch.Tensor     # (N,2) f32 (u, v) barycentrics of verts 1,2

    @property
    def valid(self):
        return self.prim >= 0


def safe_inv(d):
    """1/d with |d| clamped to at least 1e-12 (sign kept; -0 counts as +)."""
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)


def _max3(x):
    return torch.maximum(torch.maximum(x[..., 0], x[..., 1]), x[..., 2])


def _min3(x):
    return torch.minimum(torch.minimum(x[..., 0], x[..., 1]), x[..., 2])


def ray_aabb(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test; broadcasts over leading dims (..., 3). Returns
    (hit, t_near). NaN propagates through min/max, so a NaN slab misses."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = torch.maximum(_max3(torch.minimum(t0, t1)),
                          torch.as_tensor(t_min, dtype=t0.dtype,
                                          device=t0.device))
    tfar = torch.minimum(_min3(torch.maximum(t0, t1)), t_max)
    return tnear <= tfar, tnear


def moller_trumbore(o, d, tri, t_min, t_max):
    """Two-sided Möller–Trumbore; o, d (..., 3), tri (..., 9) = p0, e1, e2,
    broadcast against each other. Returns (hit, t, u, v). Every dot and
    cross product is written out left to right, as the kernels do."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    p0x, p0y, p0z = tri[..., 0], tri[..., 1], tri[..., 2]
    e1x, e1y, e1z = tri[..., 3], tri[..., 4], tri[..., 5]
    e2x, e2y, e2z = tri[..., 6], tri[..., 7], tri[..., 8]
    hx = dy * e2z - dz * e2y               # h = cross(d, e2)
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y               # q = cross(s, e1)
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    hit = ((torch.abs(a) > 1e-12) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    return hit, t, u, v
