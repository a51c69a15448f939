"""Ray cones for texture LOD (counterpart of rtxpt_tpu/core/raycone.py;
TexLODHelpers.hlsli RayCone, PathTracer.hlsli:227, 276).

A cone is a width and a spread angle, float32 lanes of the path state
(pt/integrator.py `PathState.cone_width`, `cone_spread`), unpacked: the
reference packs them to 2 x fp16 in its 96-byte payload."""
from __future__ import annotations

import math


def propagate_distance(width, spread_angle, hit_t):
    """The cone's width after a segment of length hit_t: width +
    spreadAngle * t (TexLODHelpers.hlsli propagateDistance)."""
    return width + spread_angle * hit_t


def pixel_spread_angle(fov_y: float, height: int) -> float:
    """The primary rays' spread angle a pixel: atan(2 tan(fov/2) /
    height)."""
    return math.atan(2.0 * math.tan(fov_y * 0.5) / height)
