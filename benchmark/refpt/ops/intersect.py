"""Hit record and the safe reciprocal of a ray direction (counterpart of
rtxpt_tpu/ops/intersect.py and the `_safe_inv` of
rtxpt_tpu/ops/traverse.py)."""
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
