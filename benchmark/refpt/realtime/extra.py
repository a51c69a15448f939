"""What the realtime frame needs of the port's plain modules beyond the
reference-mode copies in `refpt` (counterparts of the port's
core/mathutils.py, pt/bsdf.py `eval_split`, pt/shading.py
`make_wavefront_bsdf`, scene/lights.py `eval_sample_at`, pt/gbuffer.py
`GBuffer` and `project_to_screen`), copied as they stand."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import mathutils as mu
from ..pt import bsdf as B
from ..pt.shading import SurfaceData
from ..scene import lights as LI

W = torch.where


# ---- core/mathutils.py --------------------------------------------------

def reflect(i, n):
    """HLSL reflect: i - 2*dot(i,n)*n (i points toward the surface)."""
    return i - 2.0 * mu.dot(i, n) * n


def sample_triangle_uniform(u):
    """Uniform barycentrics via the sqrt parameterization: (b0, b1, b2)."""
    su = torch.sqrt(u[..., 0])
    b1 = 1.0 - su
    b2 = u[..., 1] * su
    return torch.stack([1.0 - b1 - b2, b1, b2], dim=-1)


def _oct_wrap(v):
    return (1.0 - torch.abs(v.flip(-1))) * torch.where(v >= 0.0, 1.0, -1.0)


def encode_oct(n):
    """Octahedral encoding of a unit vector into [0,1]^2 (Utils.hlsli:56-77)."""
    n = n / (torch.abs(n[..., 0:1]) + torch.abs(n[..., 1:2])
             + torch.abs(n[..., 2:3]))
    xy = torch.where(n[..., 2:3] >= 0.0, n[..., :2], _oct_wrap(n[..., :2]))
    return xy * 0.5 + 0.5


def decode_oct(f):
    f = f * 2.0 - 1.0
    z = 1.0 - torch.abs(f[..., 0:1]) - torch.abs(f[..., 1:2])
    t = mu.saturate(-z)
    xy = f + torch.where(f >= 0.0, -t, t)
    return mu.normalize(torch.cat([xy, z], dim=-1))


# ---- pt/bsdf.py, pt/shading.py ------------------------------------------

def eval_split(b, wi, wo):
    """Diffuse / specular split eval, f*cos (FalcorBSDF::eval with the
    split of BxDF.hlsli:764-772); the ReSTIR targets and final shading.
    b: make_bsdf's dict; wi, wo: local-frame component tuples."""
    wi_z, wo_z = wi[2], wo[2]
    ok_d = torch.minimum(wi_z, wo_z) >= B.K_MIN_COS_THETA
    w_d = B.frostbite_weight(wi, wo, b["roughness"]) * B.M_1_PI * wo_z
    ok_dt = torch.minimum(wi_z, -wo_z) >= B.K_MIN_COS_THETA
    w_dt = B.M_1_PI * -wo_z
    st, dt = b["spec_trans"], b["diff_trans"]
    on_d = b["p_diffuse"] > 0.0
    on_dt = b["p_diffuse_t"] > 0.0
    f_s = B.spec_eval(b, wi, wo)
    f_st = B.spec_trans_eval(b, wi, wo)
    diffuse, specular = [], []
    for i in range(3):
        d = W(on_d, ((1.0 - st) * (1.0 - dt))
              * W(ok_d, b["diff_albedo"][i] * w_d, 0.0), 0.0)
        d = d + W(on_dt, ((1.0 - st) * dt)
                  * W(ok_dt, b["trans_albedo"][i] * w_dt, 0.0), 0.0)
        sp = W(b["p_specular"] > 0.0, (1.0 - st) * f_s[i], 0.0)
        sp = sp + W(b["p_specular_t"] > 0.0, st * f_st[i], 0.0)
        diffuse.append(d)
        specular.append(sp)
    return tuple(diffuse), tuple(specular)


def make_wavefront_bsdf(surface: SurfaceData) -> dict:
    """FalcorBSDF::make over a wavefront (the dict of pt/bsdf.make_bsdf,
    3-vectors as component tuples); cos_v = dot(V, N) in world space."""
    d = surface.bsdf_data
    bd = dict(diffuse=d.diffuse.unbind(-1), specular=d.specular.unbind(-1),
              rough=d.roughness, metallic=d.metallic, eta=d.eta,
              trans=d.transmission.unbind(-1),
              dtrans=d.diffuse_transmission,
              strans=d.specular_transmission)
    cos_v = torch.sum(surface.sd.v * surface.sd.n, dim=-1)
    return B.make_bsdf(bd, cos_v, surface.sd.thin_surface)


# ---- scene/lights.py ----------------------------------------------------

def shaping_factor(axis, cos_cone, softness, light_to_surface):
    """evaluateLightShaping (LightShaping.hlsli:67-85): smoothstep of the
    angle between the shaping axis and the light->surface direction."""
    cos_theta = torch.sum(axis * light_to_surface, -1)
    t = torch.clamp((cos_theta - cos_cone) / torch.clamp(softness, min=1e-6),
                    0.0, 1.0)
    return torch.where(softness > 1e-6, t * t * (3.0 - 2.0 * t),
                       (cos_theta >= cos_cone).to(torch.float32))


def eval_sample_at(lt, li_idx, uv, shading_pos):
    """Re-evaluate a polymorphic light sample (light index + 2D uv) at a
    shading point (PolymorphicLight.hlsli calcSample, for the ReSTIR
    targets). Returns (direction, distance, li, inv_area, valid)."""
    row = LI.fetch_rows(lt, li_idx)
    kind = row[..., LI.LP_KIND].to(torch.int32)
    rad = row[..., LI.LP_RAD:LI.LP_RAD + 3]
    p0 = row[..., LI.LP_P0:LI.LP_P0 + 3]
    e1 = row[..., LI.LP_E1:LI.LP_E1 + 3]
    e2 = row[..., LI.LP_E2:LI.LP_E2 + 3]
    pos_l = row[..., LI.LP_POS:LI.LP_POS + 3]
    r_s = row[..., LI.LP_RADIUS]
    inv_area = row[..., LI.LP_INV_AREA]

    bary = sample_triangle_uniform(uv)
    lp_t = p0 + bary[..., 1:2] * e1 + bary[..., 2:3] * e2
    n_t = mu.safe_normalize(mu.cross(e1, e2))
    # sphere: uniform point on the surface, independent of the receiver
    z = 1.0 - 2.0 * uv[..., 0]
    s_ = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * mu.M_PI * uv[..., 1]
    n_s = torch.stack([s_ * torch.cos(phi), s_ * torch.sin(phi), z], -1)
    lp_s = pos_l + r_s[..., None] * n_s

    is_tri = kind == LI.LIGHT_TRIANGLE
    is_sph = kind == LI.LIGHT_SPHERE
    is_pt = (kind == LI.LIGHT_POINT) | (kind == LI.LIGHT_SPOT)
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
        kind == LI.LIGHT_SPOT,
        shaping_factor(row[..., LI.LP_AXIS:LI.LP_AXIS + 3],
                       row[..., LI.LP_COS_CONE], row[..., LI.LP_SOFT],
                       -dir_l), 1.0)
    li_point = rad / dist_sq[..., None] * shape[..., None]
    li = torch.where(is_area[..., None], li_area,
                     torch.where(is_pt[..., None], li_point, rad))
    valid = torch.where(is_area, cos_l > 1e-6, True)
    return direction, distance, li, inv_area, valid


# ---- pt/gbuffer.py ------------------------------------------------------

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


def project_to_screen(cam, pos):
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
