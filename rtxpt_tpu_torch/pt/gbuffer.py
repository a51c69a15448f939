"""Primary-surface buffers of the realtime mode (counterpart of
rtxpt_tpu/pt/gbuffer.py; ExportVisibilityBuffer.hlsl, RTXDI
PathTracerSurfaceData): the `GBuffer` ReSTIR reads, and screen projection
for motion vectors.

The stable-planes pipeline fills a GBuffer from the dominant plane
(models/realtime.py). The reference's single-plane `trace_gbuffer` serves
its PSR-lite pipeline, which the port does not carry yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import mathutils as mu
from ..scene.camera import CameraData
from .shading import SurfaceData


class GBuffer(NamedTuple):
    """Primary-surface SoA over pixels (flattened)."""
    valid: torch.Tensor        # (N,) bool hit anything
    prim: torch.Tensor         # (N,) i32
    bary: torch.Tensor         # (N,2)
    t: torch.Tensor            # (N,) hit distance
    pos: torch.Tensor          # (N,3) world position
    normal: torch.Tensor       # (N,3) shading normal
    face_normal: torch.Tensor  # (N,3)
    view_z: torch.Tensor       # (N,) linear depth along camera forward
    roughness: torch.Tensor    # (N,)
    diffuse_albedo: torch.Tensor   # (N,3)
    specular_albedo: torch.Tensor  # (N,3)
    emission: torch.Tensor     # (N,3)
    motion: torch.Tensor       # (N,2) screen-space motion (prev - cur), px
    view_dir: torch.Tensor     # (N,3) unit, camera -> surface
    psr_thp: torch.Tensor      # (N,3) throughput through the delta chain
    interior: torch.Tensor     # (N,2) nested stack at the surface
    surface: SurfaceData       # full surface data for shading reuse


def project_to_screen(cam: CameraData, pos):
    """World position -> (pixel coordinates (..., 2), depth along w) for
    the given camera (u, v, w are mutually orthogonal by construction)."""
    d = pos - cam.pos
    du = mu.dot(d, cam.u, False) / torch.clamp(mu.dot(cam.u, cam.u, False),
                                               min=1e-20)
    dv = mu.dot(d, cam.v, False) / torch.clamp(mu.dot(cam.v, cam.v, False),
                                               min=1e-20)
    dw = mu.dot(d, cam.w, False) / torch.clamp(mu.dot(cam.w, cam.w, False),
                                               min=1e-20)
    safe = torch.where(torch.abs(dw) < 1e-9, 1e-9, dw)
    ndc_x = du / safe
    ndc_y = dv / safe
    px = (ndc_x + 1.0) * 0.5 * cam.viewport[0] - 0.5
    py = (1.0 - ndc_y) * 0.5 * cam.viewport[1] - 0.5
    return torch.stack([px, py], dim=-1), dw
