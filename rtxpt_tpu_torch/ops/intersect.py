"""Hit record of the trace kernels (counterpart of the `Hit` of
rtxpt_tpu/ops/intersect.py)."""
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
