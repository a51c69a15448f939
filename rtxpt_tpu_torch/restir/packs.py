"""Packed row matrices for ReSTIR neighbour gathers, and the cheap
resampling targets evaluated on them (counterpart of
rtxpt_tpu/restir/packs.py).

Every cross-pixel access of the ReSTIR stages (temporal reprojection,
spatial taps, pairwise-MIS neighbour surfaces) gathers one packed row:

  surface pack  (N,16): pos xyz | normal xyz | v xyz | view_z |
                        alpha | lum_diff | lum_spec | trans_amt |
                        lum_trans | valid
  DI reservoir  (N, 8): light | uv.x uv.y | w_sum | m | target | 0 0
  GI reservoir  (N,14): pos xyz | normal xyz | radiance xyz |
                        w_sum | m | target | valid | 0

The cheap target is the reference's surface-BRDF family (RTXDI
RAB_GetLightSampleTargetPdfForSurface): Lambert + GGX-D + a transmission
floor on lobe luminances, in world space. RIS and MIS stay unbiased for
any nonnegative target used consistently; the full BSDF runs once, in
final shading.
"""
from __future__ import annotations

import torch

from ..core import mathutils as mu
from ..pt import bsdf as B
from ..pt import shading
from ..scene import envmap as EM
from ..scene import lights as LI
from .reservoir import LIGHT_ENV, LIGHT_INVALID, Reservoir

# surface pack column indices
S_POS = slice(0, 3)
S_NRM = slice(3, 6)
S_V = slice(6, 9)
S_Z = 9
S_ALPHA = 10
S_LDIFF = 11
S_LSPEC = 12
S_TRANS = 13
S_LTRANS = 14
S_VALID = 15


def pack_surface(gb) -> torch.Tensor:
    """(N,16) resampling-surface rows of a GBuffer."""
    sd = gb.surface.sd
    b = shading.make_wavefront_bsdf(gb.surface)
    trans_amt = torch.maximum(b["diff_trans"], b["spec_trans"])
    cols = [sd.pos, sd.n, sd.v, gb.view_z[..., None], b["alpha"][..., None],
            B.luminance3(b["diff_albedo"])[..., None],
            B.luminance3(b["spec_albedo"])[..., None],
            trans_amt[..., None],
            B.luminance3(b["trans_albedo"])[..., None],
            gb.valid.to(torch.float32)[..., None]]
    return torch.cat(cols, dim=-1)


def light_radiance_at(assets, pos, light, uv):
    """(Li, direction, distance) of a reservoir-encoded light sample seen
    from world position `pos` (PolymorphicLight calcSample)."""
    lt = assets.lights
    is_env = light == LIGHT_ENV
    n = light.shape[0]
    if lt is not None:
        dir_local, dist_local, li_v, _, l_ok = LI.eval_sample_at(
            lt, torch.clamp(light, min=0), uv, pos)
        li_v = torch.where(l_ok[..., None], li_v, 0.0)
    else:
        dir_local = torch.zeros((n, 3), dtype=torch.float32,
                                device=pos.device)
        dist_local = torch.zeros((n,), dtype=torch.float32, device=pos.device)
        li_v = torch.zeros_like(dir_local)
    dir_env = mu.decode_oct(uv)
    li_env = EM.eval_dir(assets.env, dir_env)
    direction = torch.where(is_env[..., None], dir_env, dir_local)
    distance = torch.where(is_env, mu.K_MAX_RAY_TRAVEL, dist_local)
    li = torch.where(is_env[..., None], li_env, li_v)
    return li, direction, distance


def _cheap_brdf(sp, direction):
    """Lambert + GGX-D + transmission floor, times the cosines, at packed
    surface rows `sp` for unit `direction`."""
    n = sp[..., S_NRM]
    v = sp[..., S_V]
    wo_z = torch.sum(direction * n, -1)
    h = mu.safe_normalize(v + direction)
    ndoth = torch.clamp(torch.sum(h * n, -1), 0.0, 1.0)
    a2 = torch.clamp(sp[..., S_ALPHA], min=0.04) ** 2
    d_ggx = a2 / (mu.M_PI * torch.square(ndoth * ndoth * (a2 - 1.0) + 1.0))
    trans_amt = sp[..., S_TRANS]
    f_r = ((1.0 - trans_amt) * sp[..., S_LDIFF] / mu.M_PI
           + sp[..., S_LSPEC] * d_ggx * 0.25) * torch.clamp(wo_z, min=0.0)
    f_t = trans_amt * torch.clamp(sp[..., S_LTRANS], min=0.25) \
        * torch.clamp(-wo_z, min=0.0) / mu.M_PI
    return f_r + f_t


def surface_target_cheap(assets, sp, light, uv):
    """Cheap DI resampling target p_hat at packed surface rows `sp`
    ((N,16), possibly gathered neighbour rows)."""
    li, direction, _ = light_radiance_at(assets, sp[..., S_POS], light, uv)
    p_hat = mu.luminance(li) * _cheap_brdf(sp, direction)
    return torch.where((sp[..., S_VALID] > 0.5) & (light != LIGHT_INVALID),
                       p_hat, 0.0)


def gi_target_cheap(sp, pos, radiance, valid):
    """Cheap GI resampling target at packed surface rows for a secondary
    sample at `pos` with outgoing radiance `radiance`."""
    to_s = pos - sp[..., S_POS]
    dist_sq = torch.clamp(torch.sum(to_s * to_s, -1), min=1e-9)
    direction = to_s / torch.sqrt(dist_sq)[..., None]
    p_hat = mu.luminance(radiance) * _cheap_brdf(sp, direction)
    return torch.where((sp[..., S_VALID] > 0.5) & valid, p_hat, 0.0)


def pack_reservoir(r: Reservoir) -> torch.Tensor:
    """(N,8): light | uv | w_sum | m | target | pad. The i32 light index
    rides as raw bits in an f32 column (a bit view, not a value cast), so
    rows move by copy only."""
    n = r.light.shape[0]
    return torch.cat([
        r.light.to(torch.int32).view(torch.float32)[..., None], r.uv,
        r.w_sum[..., None], r.m[..., None], r.target[..., None],
        torch.zeros((n, 2), dtype=torch.float32, device=r.uv.device)], -1)


def unpack_reservoir(rows) -> Reservoir:
    return Reservoir(light=rows[..., 0].contiguous().view(torch.int32),
                     uv=rows[..., 1:3], w_sum=rows[..., 3], m=rows[..., 4],
                     target=rows[..., 5])


def pack_gi_reservoir(r) -> torch.Tensor:
    """(N,14): pos | normal | radiance | w_sum | m | target | valid | pad."""
    n = r.w_sum.shape[0]
    return torch.cat([
        r.pos, r.normal, r.radiance, r.w_sum[..., None], r.m[..., None],
        r.target[..., None], r.valid.to(torch.float32)[..., None],
        torch.zeros((n, 1), dtype=torch.float32, device=r.pos.device)], -1)


def unpack_gi_reservoir(rows):
    from .gi import GIReservoir
    return GIReservoir(pos=rows[..., 0:3], normal=rows[..., 3:6],
                       radiance=rows[..., 6:9], w_sum=rows[..., 9],
                       m=rows[..., 10], target=rows[..., 11],
                       valid=rows[..., 12] > 0.5)
