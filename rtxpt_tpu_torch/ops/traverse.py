"""Trace dispatch (counterpart of rtxpt_tpu/ops/traverse.py).

Every trace goes to the dense tier (ops/mt_dense.py). Scenes over
mt_dense.MAX_TRIS triangles need the BVH8, two-level and instanced
traversal paths of the reference, which the port does not carry yet.
"""
from __future__ import annotations

from . import mt_dense
from .intersect import Hit


def _require_dense(dense):
    if dense is None:
        raise NotImplementedError(
            f"scenes over {mt_dense.MAX_TRIS} triangles need the BVH "
            "trace paths, which are not ported yet")


def trace_closest(dense, origins, dirs, t_max=1e30, active=None) -> Hit:
    """Closest-hit trace (Bridge::traceScatterRay equivalent); prim is the
    original scene triangle index."""
    _require_dense(dense)
    return mt_dense.trace_closest(dense, origins, dirs, t_max, active)


def trace_anyhit(dense, origins, dirs, t_max=1e30, active=None):
    """Visibility trace (Bridge::traceVisibilityRay equivalent): True where
    occluded; inactive rays report unoccluded."""
    _require_dense(dense)
    return mt_dense.trace_anyhit(dense, origins, dirs, t_max, active)
