"""Per-pixel shader Print: the reference's DebugPrint slot buffer
(counterpart of rtxpt_tpu/utils/debugprint.py; RTXPT/PathTracer/
ShaderDebug.hlsli Print(slot, val) and MAX_DEBUG_PRINT_SLOTS, :97,263-275,
with the SampleUI feedback readback that shows them).

The wavefront keeps no per-pixel side channel, so the probe re-walks the
picked pixel's deterministic bounce chain (the walk of
debuglines.lines_for_path) as 1-lane traces and surface fetches, and
fills the slot buffer on the host: one header slot, then two slots per
path vertex (hit geometry, then throughput). `format_slots` prints the
table as SampleUI prints the feedback struct.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

MAX_DEBUG_PRINT_SLOTS = 16


def pixel_paths(cam, x: int, y: int, max_bounces: int, device):
    """The 1-lane PathState of pixel (x, y)'s first sample (the reference
    configuration's camera ray)."""
    from .. import config as C
    from ..models.renderer import reference_config
    from ..pt import integrator
    px = torch.tensor([x], dtype=torch.int64, device=device)
    py = torch.tensor([y], dtype=torch.int64, device=device)
    return integrator.init_paths(cam, px, py,
                                 reference_config(max_bounces=max_bounces),
                                 C.default_constants(0), 0)


def mirror_step(surf, direction):
    """The deterministic mirror continuation about the shading normal
    that the print and line probes walk: (new origin, new direction)."""
    sd = surf.sd
    d_new = direction - 2.0 * torch.sum(direction * sd.n, -1,
                                        keepdim=True) * sd.n
    origin = sd.compute_new_ray_origin(
        torch.ones(1, dtype=torch.bool, device=direction.device))
    return origin, d_new / torch.clamp(
        torch.linalg.norm(d_new, dim=-1, keepdim=True), min=1e-9)


def print_path(assets, cam, x: int, y: int, *, max_bounces: int = 6
               ) -> List[Dict]:
    """Fill the print-slot buffer from pixel (x, y)'s bounce chain.

    Returns a list of slot dicts {"slot": i, "label": str, "value": (4,)
    float32}. Slot 0 is the pixel header; each path vertex d adds the
    slots v<d>.hit (t, prim, material id, roughness) and v<d>.thp
    (throughput rgb, the shading normal's y). Stops at
    MAX_DEBUG_PRINT_SLOTS, as the reference's bounded UAV writes do."""
    from ..ops import traverse
    from ..pt import shading

    dev = assets.scene.positions.device
    p = pixel_paths(cam, x, y, max_bounces, dev)
    origin, direction, active = p.origin, p.direction, p.active

    slots: List[Dict] = [dict(
        slot=0, label="pixel",
        value=np.array([float(x), float(y), float(max_bounces), 0.0],
                       np.float32))]
    thp = torch.ones((1, 3), dtype=torch.float32, device=dev)
    for depth in range(max_bounces + 1):
        if len(slots) + 2 > MAX_DEBUG_PRINT_SLOTS:
            break
        hit = traverse.trace_closest(assets.accel, origin, direction,
                                     active=active)
        if not bool((hit.valid & active)[0]):
            t_miss = float(hit.t[0])
            slots.append(dict(
                slot=len(slots), label=f"v{depth}.miss",
                value=np.array([t_miss if t_miss < 1e29 else -1.0,
                                -1.0, -1.0, 0.0], np.float32)))
            break
        surf = shading.load_surface(assets.scene, torch.clamp(hit.prim, min=0),
                                    hit.bary, direction)
        sd = surf.sd
        # one copy to the host for the vertex's slots
        row = torch.cat([hit.t, hit.prim.to(torch.float32),
                         sd.material_id.to(torch.float32),
                         surf.bsdf_data.roughness, thp[0], sd.n[0, 1:2]]
                        ).cpu().numpy()
        slots.append(dict(slot=len(slots), label=f"v{depth}.hit",
                          value=row[0:4].astype(np.float32)))
        slots.append(dict(slot=len(slots), label=f"v{depth}.thp",
                          value=row[4:8].astype(np.float32)))
        # the throughput picks up the specular albedo at each vertex
        thp = thp * torch.clamp(surf.bsdf_data.specular, 0.0, 1.0)
        origin, direction = mirror_step(surf, direction)
        active = active & hit.valid
    return slots


def format_slots(slots: List[Dict]) -> str:
    """SampleUI-style debug print table."""
    lines = [f"debug print ({len(slots)}/{MAX_DEBUG_PRINT_SLOTS} slots)"]
    for s in slots:
        v = s["value"]
        lines.append(
            f"  [{s['slot']:2d}] {s['label']:<10s} "
            f"{v[0]:10.4f} {v[1]:10.4f} {v[2]:10.4f} {v[3]:10.4f}")
    return "\n".join(lines)
