"""Trace dispatch (counterpart of rtxpt_tpu/ops/traverse.py).

The trace structure's type picks the path, in the reference's tier order:
a `DenseMT` (at most 8,192 triangles) goes to the dense trace
(``ops/mt_dense.py``: one launch of `trace_dense_fused` per trace, which
builds its tiles' worklists itself), a
`BVH8TwoLevel` (over 45,000 triangles) to
``ops/bvh2l.py`` (the whole two-level trace in one launch of
``traverse_bvh8.trace_bvh8_2l``), a single `BVH8` to K5
(``ops/traverse_bvh8.py``), whose leaf slots map to triangle ids through
the table's `leaf_tris`, and an `InstancedTL` (rigid-animated scenes over
45,000 triangles, models/renderer.py's instanced gate) to
``ops/instanced.py``: near-to-far rounds over instance chunks, each round
one K5 launch against a mesh's object-space table.
"""
from __future__ import annotations

import torch

from . import bvh2l, instanced, mt_dense
from . import traverse_bvh8 as T8
from ..utils import profiling
from .bvh import BVH8
from .intersect import Hit


def _trace_bvh8(accel: BVH8, origins, dirs, t_max, active, any_hit):
    o, d, tm, act = T8.prepare_rays(origins, dirs, t_max, active)
    return T8.trace_bvh8(accel.table, accel.leaf_omm, o, d, tm, act,
                         leaf_size=accel.leaf_size, any_hit=any_hit)


def trace_closest(accel, origins, dirs, t_max=1e30, active=None) -> Hit:
    """Closest-hit trace (Bridge::traceScatterRay equivalent); prim is the
    original scene triangle index."""
    with profiling.span("trace_closest"):
        if isinstance(accel, mt_dense.DenseMT):
            return mt_dense.trace_closest(accel, origins, dirs, t_max, active)
        if isinstance(accel, bvh2l.BVH8TwoLevel):
            return bvh2l.trace_closest(accel, origins, dirs, t_max, active)
        if isinstance(accel, instanced.InstancedTL):
            return instanced.trace_closest(accel, origins, dirs, t_max=t_max,
                                           active=active)
        if isinstance(accel, BVH8):
            t, slot, uv = _trace_bvh8(accel, origins, dirs, t_max, active,
                                      False)
            prim = torch.where(slot >= 0,
                               accel.leaf_tris[torch.clamp(slot, min=0)], -1)
            return Hit(t, prim, uv)
        raise TypeError(f"no trace path for {type(accel).__name__}")


def trace_anyhit(accel, origins, dirs, t_max=1e30, active=None):
    """Visibility trace (Bridge::traceVisibilityRay equivalent): True where
    occluded; inactive rays report unoccluded."""
    with profiling.span("trace_anyhit"):
        if isinstance(accel, mt_dense.DenseMT):
            return mt_dense.trace_anyhit(accel, origins, dirs, t_max, active)
        if isinstance(accel, bvh2l.BVH8TwoLevel):
            return bvh2l.trace_anyhit(accel, origins, dirs, t_max, active)
        if isinstance(accel, instanced.InstancedTL):
            return instanced.trace_anyhit(accel, origins, dirs, t_max=t_max,
                                          active=active)
        if isinstance(accel, BVH8):
            return _trace_bvh8(accel, origins, dirs, t_max, active,
                               True)[1] >= 0
        raise TypeError(f"no trace path for {type(accel).__name__}")
