"""Local lights: emissive triangles + analytic lights (counterpart of
rtxpt_tpu/scene/lights.py; PrepareLightsPass, PolymorphicLight.hlsli).

The table is built host-side (numpy) and packed into one 24-column row
per light, so a sampled light costs one row fetch (`ops/gather.py`). The
per-light geometry of a local NEE sample is evaluated inside the shade
kernel (pt/shade_kernel.py); this module picks lights and fetches rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import gather

LIGHT_TRIANGLE = 0
LIGHT_POINT = 1
LIGHT_DIRECTIONAL = 2
LIGHT_SPHERE = 3
LIGHT_SPOT = 4

LP_KIND = 0
LP_P0 = 1           # 1:4
LP_E1 = 4           # 4:7
LP_E2 = 7           # 7:10
LP_POS = 10         # 10:13
LP_RADIUS = 13
LP_RAD = 14         # 14:17
LP_INV_AREA = 17
LP_POWER = 18
LP_AXIS = 19        # 19:22 spot primary axis
LP_COS_CONE = 22    # cos(outer cone angle)
LP_SOFT = 23        # cone softness (cosine-space smoothstep width)
LP_COLS = 24


@dataclasses.dataclass
class LightTable:
    pack: torch.Tensor       # (L, LP_COLS) f32 packed rows
    cdf: torch.Tensor        # (L,) f32 inclusive normalized power CDF
    total_power: float

    @property
    def count(self) -> int:
        return self.pack.shape[0]


def shaping_flux_factor(cos_cone, softness):
    """getShapingFluxFactor (LightShaping.hlsli:151-165)."""
    return (1.0 - cos_cone) * (1.0 - 0.5 * softness) * 0.5


def _build_pack(kind, tri, position, radius, radiance, positions, indices,
                power, axis, cone):
    """Assemble the packed light rows (numpy)."""
    t = np.clip(tri, 0, indices.shape[0] - 1)
    tri_idx = indices[t]
    p0 = positions[tri_idx[:, 0]]
    e1 = positions[tri_idx[:, 1]] - p0
    e2 = positions[tri_idx[:, 2]] - p0
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    inv_area = np.where(
        kind == LIGHT_TRIANGLE, 1.0 / np.maximum(area, 1e-9),
        np.where(kind == LIGHT_SPHERE,
                 1.0 / np.maximum(4.0 * np.pi * radius * radius, 1e-9), 1.0))
    return np.concatenate([
        kind[:, None].astype(np.float32), p0, e1, e2, position,
        radius[:, None], radiance, inv_area[:, None], power[:, None],
        axis, cone], axis=-1).astype(np.float32)


def build_light_table(host_scene: dict, analytic: Optional[list] = None,
                      device="cpu") -> Optional[LightTable]:
    """Host-side (numpy) light table build (PrepareLightsPass::Process).
    analytic: list of dicts {kind, position/direction, radiance, radius}."""
    pos = host_scene["positions"]
    idx = host_scene["indices"]
    tri_mat = host_scene["tri_mat"]
    mats = host_scene["materials"]
    emissive = mats["emissive"]
    excluded = mats["excluded_from_nee"]

    kinds, tris, positions, radii, radiances, powers = [], [], [], [], [], []
    em_lum = (0.2126 * emissive[:, 0] + 0.7152 * emissive[:, 1]
              + 0.0722 * emissive[:, 2])
    is_emissive_mat = (em_lum > 0) & (~excluded)
    emissive_tris = np.nonzero(is_emissive_mat[tri_mat])[0]
    if emissive_tris.size:
        et = emissive_tris
        p0 = pos[idx[et, 0]]
        p1 = pos[idx[et, 1]]
        p2 = pos[idx[et, 2]]
        area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
        mids = tri_mat[et]
        kinds.extend([LIGHT_TRIANGLE] * et.size)
        tris.extend(et.tolist())
        positions.extend(((p0 + p1 + p2) / 3.0).astype(np.float32))
        radii.extend([0.0] * et.size)
        radiances.extend(emissive[mids].astype(np.float32))
        # single-sided emissive: power = L * area * pi
        powers.extend((em_lum[mids] * area * np.pi).tolist())

    axes, cones = [[0.0, 0.0, -1.0]] * len(kinds), \
        [[-1.0, 0.0]] * len(kinds)
    for a in (analytic or []):
        kinds.append(a["kind"])
        tris.append(-1)
        positions.append(np.asarray(a.get("position",
                                          a.get("direction", (0, 1, 0))),
                                    np.float32))
        radii.append(a.get("radius", 0.0))
        rad = np.asarray(a["radiance"], np.float32)
        radiances.append(rad)
        lum = float(np.float32(0.2126) * rad[0] + np.float32(0.7152) * rad[1]
                    + np.float32(0.0722) * rad[2])
        if a["kind"] == LIGHT_SPOT:
            outer = float(a.get("outer_angle", np.pi / 4))
            inner = float(a.get("inner_angle", 0.0))
            soft = float(np.clip(1.0 - inner / max(outer, 1e-6), 0, 1))
            ax = np.asarray(a.get("axis", (0, 0, -1)), np.float32)
            ax = ax / max(np.linalg.norm(ax), 1e-9)
            axes.append(ax.tolist())
            cones.append([float(np.cos(outer)), soft])
        else:
            axes.append([0.0, 0.0, -1.0])
            cones.append([-1.0, 0.0])
        if a["kind"] == LIGHT_POINT:
            powers.append(lum * 4.0 * np.pi)
        elif a["kind"] == LIGHT_SPOT:
            powers.append(lum * 4.0 * np.pi * float(shaping_flux_factor(
                cones[-1][0], cones[-1][1])))
        elif a["kind"] == LIGHT_SPHERE:
            r = a.get("radius", 0.1)
            powers.append(lum * 4.0 * np.pi * np.pi * r * r)
        else:  # directional handled by env-map bake in the reference
            powers.append(lum)

    if not kinds:
        return None
    power = np.asarray(powers, np.float32)
    cdf = np.cumsum(power)
    total = float(cdf[-1])
    cdf = (cdf / max(total, 1e-20)).astype(np.float32)
    pack = _build_pack(np.asarray(kinds, np.int32), np.asarray(tris, np.int32),
                       np.stack(positions).astype(np.float32),
                       np.asarray(radii, np.float32),
                       np.stack(radiances).astype(np.float32),
                       np.asarray(pos, np.float32), np.asarray(idx, np.int64),
                       power, np.asarray(axes, np.float32),
                       np.asarray(cones, np.float32))
    return LightTable(pack=torch.as_tensor(pack, device=device),
                      cdf=torch.as_tensor(cdf, device=device),
                      total_power=float(np.float32(total)))


def pick_light(lt: LightTable, u):
    """Power-CDF selection: index of the first cdf entry >= u."""
    L = lt.count
    if L <= 1024:
        idx = torch.sum((lt.cdf[None, :] < u[..., None]).to(torch.int32),
                        dim=-1)
    else:
        idx = torch.searchsorted(lt.cdf, u.contiguous(), side="left")
    return torch.clamp(idx, 0, L - 1).to(torch.int32)


def fetch_rows(lt: LightTable, idx):
    """(N, LP_COLS) packed light rows (row gather kernel)."""
    return gather.gather_rows(lt.pack, idx)
