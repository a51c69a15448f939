"""Visibility rays (counterpart of rtxpt_tpu/pt/visibility.py).

The slice carries the plain any-hit path, which the reference takes for
scenes without alpha-MASK materials. The exact alpha re-queue of the
reference (closest trace + texture alpha test per hit) comes with the
texture queue; the Renderer refuses MASK scenes until then.
"""
from __future__ import annotations

from ..ops import traverse


def trace_visibility(assets, origins, dirs, t_max=1e30, active=None):
    """True where the segment (0, t_max) is occluded."""
    return traverse.trace_anyhit(assets.dense, origins, dirs, t_max=t_max,
                                 active=active)
