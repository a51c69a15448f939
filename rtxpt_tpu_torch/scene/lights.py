"""Local lights: emissive triangles + analytic lights (counterpart of
rtxpt_tpu/scene/lights.py; PrepareLightsPass, PolymorphicLight.hlsli).

The table is built host-side (numpy) and packed into one 24-column row
per light, so a sampled light costs one row fetch (`ops/gather.py`). The
per-light geometry of a local NEE sample is evaluated inside the shade
kernel (pt/shade_kernel.py) on the fused path, and by
`sample_local_lights` on the chain of tensor ops; this module also picks
lights, fetches rows and re-evaluates a reservoir's (light, uv) sample at
a shading point for ReSTIR and ReGIR (`eval_sample_at`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import mathutils as mu
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


def shaping_factor(axis, cos_cone, softness, light_to_surface):
    """evaluateLightShaping (LightShaping.hlsli:67-85): smoothstep of the
    angle between the shaping axis and the light->surface direction."""
    cos_theta = torch.sum(axis * light_to_surface, -1)
    t = torch.clamp((cos_theta - cos_cone) / torch.clamp(softness, min=1e-6),
                    0.0, 1.0)
    return torch.where(softness > 1e-6, t * t * (3.0 - 2.0 * t),
                       (cos_theta >= cos_cone).to(torch.float32))


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
                      device="cuda") -> Optional[LightTable]:
    """Host-side (numpy) light table build (PrepareLightsPass::Process):
    one row per emissive triangle (whole arrays, no per-triangle Python:
    the default city has 64,066), then the analytic lights.
    analytic: list of dicts {kind, position/direction, radiance, radius}."""
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

    for a in (analytic or []):
        kinds.append(np.asarray([a["kind"]], np.int32))
        tris.append(np.asarray([-1], np.int32))
        positions.append(np.asarray(a.get(
            "position", a.get("direction", (0, 1, 0))), np.float32)[None])
        radii.append(np.asarray([a.get("radius", 0.0)], np.float32))
        rad = np.asarray(a["radiance"], np.float32)
        radiances.append(rad[None])
        lum = float(np.float32(0.2126) * rad[0] + np.float32(0.7152) * rad[1]
                    + np.float32(0.0722) * rad[2])
        if a["kind"] == LIGHT_SPOT:
            outer = float(a.get("outer_angle", np.pi / 4))
            inner = float(a.get("inner_angle", 0.0))
            soft = float(np.clip(1.0 - inner / max(outer, 1e-6), 0, 1))
            ax = np.asarray(a.get("axis", (0, 0, -1)), np.float32)
            ax = ax / max(np.linalg.norm(ax), 1e-9)
            axis, cone = ax.tolist(), [float(np.cos(outer)), soft]
        else:
            axis, cone = [0.0, 0.0, -1.0], [-1.0, 0.0]
        axes.append(np.asarray([axis], np.float32))
        cones.append(np.asarray([cone], np.float32))
        if a["kind"] == LIGHT_POINT:
            power = lum * 4.0 * np.pi
        elif a["kind"] == LIGHT_SPOT:
            power = lum * 4.0 * np.pi * float(shaping_flux_factor(*cone))
        elif a["kind"] == LIGHT_SPHERE:
            r = a.get("radius", 0.1)
            power = lum * 4.0 * np.pi * np.pi * r * r
        else:  # directional handled by env-map bake in the reference
            power = lum
        powers.append(np.asarray([power], np.float64))

    if et.size + len(analytic or []) == 0:
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


def refresh_pack(lt: Optional[LightTable], positions, indices
                 ) -> Optional[LightTable]:
    """The rows' triangle vertices (p0, e1, e2) and inverse areas re-read
    from (posed) device positions: the light side of Scene::Refresh
    (rtxpt_tpu/scene/lights.py:123-131). Like the reference, every row
    re-reads its triangle clamped to the table, an analytic row triangle
    0, whose columns its evaluation never reads; centroids and powers
    keep their build-time values."""
    if lt is None:
        return lt
    if lt.tri is None:
        raise ValueError("refresh_pack: the light table carries no "
                         "triangle ids")
    t = lt.tri.long().clamp(0, indices.shape[0] - 1)
    tri_idx = indices[t].long()
    p0 = positions[tri_idx[:, 0]]
    e1 = positions[tri_idx[:, 1]] - p0
    e2 = positions[tri_idx[:, 2]] - p0
    area = 0.5 * torch.linalg.norm(torch.cross(e1, e2, dim=-1), dim=-1)
    kind = lt.pack[:, LP_KIND]
    radius = lt.pack[:, LP_RADIUS]
    inv_area = torch.where(
        kind == LIGHT_TRIANGLE, 1.0 / torch.clamp(area, min=1e-9),
        torch.where(kind == LIGHT_SPHERE,
                    1.0 / torch.clamp(4.0 * np.pi * radius * radius,
                                      min=1e-9), 1.0))
    pack = lt.pack.clone()
    pack[:, LP_P0:LP_P0 + 3] = p0
    pack[:, LP_E1:LP_E1 + 3] = e1
    pack[:, LP_E2:LP_E2 + 3] = e2
    pack[:, LP_INV_AREA] = inv_area
    return dataclasses.replace(lt, pack=pack)


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


def eval_sample_at(lt: LightTable, li_idx, uv, shading_pos):
    """Re-evaluate a polymorphic light sample (light index + 2D uv) at a
    shading point (PolymorphicLight.hlsli calcSample, for the ReSTIR
    targets). Area lights (triangle, sphere) give li = radiance * cos_l /
    dist^2 for an area-measure sample, so pick_pdf * inv_area is the
    matching source pdf; delta lights give intensity / dist^2 (point,
    spot) or radiance (directional). Returns (direction, distance, li,
    inv_area, valid)."""
    return eval_row_at(fetch_rows(lt, li_idx), uv, shading_pos)


def eval_row_at(row, uv, shading_pos):
    """`eval_sample_at` on the light's fetched (N, LP_COLS) rows."""
    kind = row[..., LP_KIND].to(torch.int32)
    rad = row[..., LP_RAD:LP_RAD + 3]
    p0 = row[..., LP_P0:LP_P0 + 3]
    e1 = row[..., LP_E1:LP_E1 + 3]
    e2 = row[..., LP_E2:LP_E2 + 3]
    pos_l = row[..., LP_POS:LP_POS + 3]
    r_s = row[..., LP_RADIUS]
    inv_area = row[..., LP_INV_AREA]

    bary = mu.sample_triangle_uniform(uv)
    lp_t = p0 + bary[..., 1:2] * e1 + bary[..., 2:3] * e2
    n_t = mu.safe_normalize(mu.cross(e1, e2))
    # sphere: uniform point on the surface, independent of the receiver
    z = 1.0 - 2.0 * uv[..., 0]
    s_ = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * mu.M_PI * uv[..., 1]
    n_s = torch.stack([s_ * torch.cos(phi), s_ * torch.sin(phi), z], -1)
    lp_s = pos_l + r_s[..., None] * n_s

    is_tri = kind == LIGHT_TRIANGLE
    is_sph = kind == LIGHT_SPHERE
    is_pt = (kind == LIGHT_POINT) | (kind == LIGHT_SPOT)
    is_area = is_tri | is_sph
    lp = torch.where(is_tri[..., None], lp_t,
                     torch.where(is_sph[..., None], lp_s, pos_l))
    nrm = torch.where(is_tri[..., None], n_t, n_s)
    to_l = lp - shading_pos
    dist_sq = torch.clamp(torch.sum(to_l * to_l, -1), min=1e-9)
    dist = torch.sqrt(dist_sq)
    dir_l = to_l / dist[..., None]
    cos_l = torch.sum(nrm * (-dir_l), -1)
    dir_d = -mu.safe_normalize(pos_l)
    direction = torch.where((is_area | is_pt)[..., None], dir_l, dir_d)
    distance = torch.where(is_area | is_pt, dist,
                           torch.full_like(dist, mu.K_MAX_RAY_TRAVEL))
    li_area = rad * (torch.clamp(cos_l, min=0.0) / dist_sq)[..., None]
    shape = torch.where(
        kind == LIGHT_SPOT,
        shaping_factor(row[..., LP_AXIS:LP_AXIS + 3], row[..., LP_COS_CONE],
                       row[..., LP_SOFT], -dir_l), 1.0)
    li_point = rad / dist_sq[..., None] * shape[..., None]
    li = torch.where(is_area[..., None], li_area,
                     torch.where(is_pt[..., None], li_point, rad))
    valid = torch.where(is_area, cos_l > 1e-6, True)
    return direction, distance, li, inv_area, valid


def sample_local_lights(lt: LightTable, shading_pos, u3) -> LightSample:
    """Power-weighted light pick + per-light solid-angle sample
    (PolymorphicLight.hlsli calcSample); u3 (N,3) = [light select, area
    sample x2]. One CDF pick and one row fetch (K2) per lane."""
    li_idx = pick_light(lt, u3[..., 0])
    row = fetch_rows(lt, li_idx)
    kind = row[..., LP_KIND].to(torch.int32)
    pick_pdf = row[..., LP_POWER] / max(lt.total_power, 1e-20)
    p0 = row[..., LP_P0:LP_P0 + 3]
    e1 = row[..., LP_E1:LP_E1 + 3]
    e2 = row[..., LP_E2:LP_E2 + 3]
    pos_l = row[..., LP_POS:LP_POS + 3]
    r_s = row[..., LP_RADIUS]
    rad = row[..., LP_RAD:LP_RAD + 3]
    inv_area = row[..., LP_INV_AREA]

    # triangle lights: uniform area sample
    bary = mu.sample_triangle_uniform(u3[..., 1:3])
    lp = p0 + bary[..., 1:2] * e1 + bary[..., 2:3] * e2
    fn = mu.safe_normalize(mu.cross(e1, e2))
    to_l = lp - shading_pos
    dist_sq = torch.clamp(torch.sum(to_l * to_l, -1), min=1e-12)
    dist = torch.sqrt(dist_sq)
    dir_ = to_l / dist[..., None]
    cos_l = torch.sum(fn * (-dir_), -1)     # the light faces its +normal
    # area pdf -> solid-angle pdf (inv_area = 1/area for triangles)
    pdf_tri = dist_sq * inv_area / torch.clamp(cos_l, min=1e-12)

    # point and spot lights (radiance = intensity [W/sr])
    to_p = pos_l - shading_pos
    dist_p_sq = torch.clamp(torch.sum(to_p * to_p, -1), min=1e-12)
    dist_p = torch.sqrt(dist_p_sq)
    dir_p = to_p / dist_p[..., None]

    # sphere: uniform area sample over the surface
    z = 1.0 - 2.0 * u3[..., 1]
    s_ = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * mu.M_PI * u3[..., 2]
    n_s = torch.stack([s_ * torch.cos(phi), s_ * torch.sin(phi), z], -1)
    lp_s = pos_l + r_s[..., None] * n_s
    to_s = lp_s - shading_pos
    dist_s_sq = torch.clamp(torch.sum(to_s * to_s, -1), min=1e-12)
    dist_s = torch.sqrt(dist_s_sq)
    dir_s = to_s / dist_s[..., None]
    cos_s = torch.sum(n_s * (-dir_s), -1)
    pdf_sph = dist_s_sq * inv_area / torch.clamp(cos_s, min=1e-12)

    # directional: a fixed direction at infinite distance
    dir_d = -mu.safe_normalize(pos_l)

    is_tri = kind == LIGHT_TRIANGLE
    is_sph = kind == LIGHT_SPHERE
    is_spot = kind == LIGHT_SPOT
    is_pt = (kind == LIGHT_POINT) | is_spot
    is_dir = kind == LIGHT_DIRECTIONAL
    w3 = lambda c, a, b: torch.where(c[..., None], a, b)
    direction = w3(is_tri, dir_, w3(is_sph, dir_s, w3(is_pt, dir_p, dir_d)))
    far = torch.full_like(dist, mu.K_MAX_RAY_TRAVEL)
    distance = torch.where(is_tri, dist, torch.where(
        is_sph, dist_s, torch.where(is_pt, dist_p, far)))
    # solid-angle pdf; the delta lights keep the selection pdf alone and
    # fold the geometric term into li
    pdf = torch.where(is_tri, pdf_tri * pick_pdf,
                      torch.where(is_sph, pdf_sph * pick_pdf, pick_pdf))
    shape = torch.where(
        is_spot, shaping_factor(row[..., LP_AXIS:LP_AXIS + 3],
                                row[..., LP_COS_CONE], row[..., LP_SOFT],
                                -dir_p), 1.0)
    pick_c = torch.clamp(pick_pdf, min=1e-20)[..., None]
    li = w3(is_tri | is_sph, rad / torch.clamp(pdf, min=1e-20)[..., None],
            w3(is_pt, rad * shape[..., None] / dist_p_sq[..., None]
               / pick_c, rad / pick_c))
    valid = torch.where(is_tri, cos_l > 1e-6,
                        torch.where(is_sph, cos_s > 1e-6, is_pt | is_dir))
    return LightSample(direction=direction, distance=distance, li=li,
                       pdf=pdf, valid=valid, delta=is_pt | is_dir)
