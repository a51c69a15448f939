"""Local lights: emissive triangles (counterpart of
rtxpt_tpu/scene/lights.py; PrepareLightsPass, PolymorphicLight.hlsli).

The table is built host-side (numpy) and packed into one 24-column row
per light, so a sampled light costs one row fetch (`ops/gather.py`). The
per-light geometry of a local NEE sample is evaluated inside the shade
pass (pt/shade_kernel.py); this module builds the table, picks lights and
fetches their rows.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

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
    # (L,) i32 scene triangle of each row (-1: analytic), which
    # refresh_pack re-reads; None where the rows cannot be refreshed
    tri: Optional[torch.Tensor] = None

    @property
    def count(self) -> int:
        return self.pack.shape[0]


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


def build_light_table(host_scene: dict,
                      device="cuda") -> Optional[LightTable]:
    """Host-side (numpy) light table build (PrepareLightsPass::Process):
    one row per emissive triangle (whole arrays, no per-triangle Python:
    the default city has 64,066)."""
    pos = host_scene["positions"]
    idx = host_scene["indices"]
    tri_mat = host_scene["tri_mat"]
    mats = host_scene["materials"]
    emissive = mats["emissive"]
    excluded = mats["excluded_from_nee"]

    em_lum = (0.2126 * emissive[:, 0] + 0.7152 * emissive[:, 1]
              + 0.0722 * emissive[:, 2])
    is_emissive_mat = (em_lum > 0) & (~excluded)
    et = np.nonzero(is_emissive_mat[tri_mat])[0]
    p0 = pos[idx[et, 0]]
    p1 = pos[idx[et, 1]]
    p2 = pos[idx[et, 2]]
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    mids = tri_mat[et]
    kinds = [np.full(et.size, LIGHT_TRIANGLE, np.int32)]
    tris = [et.astype(np.int32)]
    positions = [((p0 + p1 + p2) / 3.0).astype(np.float32).reshape(-1, 3)]
    radii = [np.zeros(et.size, np.float32)]
    radiances = [emissive[mids].astype(np.float32).reshape(-1, 3)]
    # single-sided emissive: power = L * area * pi
    powers = [np.asarray(em_lum[mids] * area * np.pi, np.float64)]
    axes = [np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32),
                    (et.size, 1))]
    cones = [np.tile(np.asarray([[-1.0, 0.0]], np.float32), (et.size, 1))]

    if et.size == 0:
        return None
    power = np.concatenate(powers).astype(np.float32)
    cdf = np.cumsum(power)
    total = float(cdf[-1])
    cdf = (cdf / max(total, 1e-20)).astype(np.float32)
    pack = _build_pack(np.concatenate(kinds), np.concatenate(tris),
                       np.concatenate(positions), np.concatenate(radii),
                       np.concatenate(radiances),
                       np.asarray(pos, np.float32), np.asarray(idx, np.int64),
                       power, np.concatenate(axes), np.concatenate(cones))
    return LightTable(pack=torch.as_tensor(pack, device=device),
                      cdf=torch.as_tensor(cdf, device=device),
                      total_power=float(np.float32(total)),
                      tri=torch.as_tensor(np.concatenate(tris),
                                          device=device))


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
    """(N, LP_COLS) packed light rows (row gather)."""
    return gather.gather_rows(lt.pack, idx)


class LightSample(NamedTuple):
    """PathLightSample (PathTracerTypes.hlsli): radiance already divided
    by the pdf in li; the solid-angle pdf kept for MIS."""
    direction: torch.Tensor   # (N,3)
    distance: torch.Tensor    # (N,)
    li: torch.Tensor          # (N,3) radiance / pdf
    pdf: torch.Tensor         # (N,)
    valid: torch.Tensor       # (N,) bool
    delta: torch.Tensor       # (N,) bool point/spot/directional: no scatter
    #                           ray reaches them, so their NEE MIS weight is 1
