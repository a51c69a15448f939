"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit), and the work of a trace call counted from its
arguments alone."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # HBM3

RAY_BYTES = 28                   # origin, direction, t_max (float32)
CLOSEST_HIT_BYTES = 16           # t, triangle id, (u, v)
ANY_HIT_BYTES = 1                # the occluded flag
TRIANGLE_BYTES = 36              # three float32 corners


def trace_bytes(name: str, active_rays: int, triangles: int) -> int:
    """The least bytes a trace call moves: each active ray read once, its
    hit record written once, every triangle of the scene read once."""
    out = CLOSEST_HIT_BYTES if name == "trace_closest" else ANY_HIT_BYTES
    return active_rays * (RAY_BYTES + out) + triangles * TRIANGLE_BYTES
