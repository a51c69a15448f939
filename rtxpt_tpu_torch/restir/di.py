"""ReSTIR DI: the per-pixel light reservoir pipeline (counterpart of
rtxpt_tpu/restir/di.py; RtxdiPass.cpp:268-395: presample -> initial
candidates -> temporal resampling -> spatial resampling -> final shading;
GenerateInitialSamples.hlsl, TemporalResampling.hlsl,
SpatialResampling.hlsl, DIFinalShading.hlsl).

Each stage is tensor code over the (H*W,) pixel wavefront. Neighbour taps
gather packed rows (restir/packs.py); temporal reuse reprojects with the
G-buffer motion vectors and validates depth and normal; spatial reuse uses
RTXDI's pairwise MIS. Visibility rays go through pt/visibility.py.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core import mathutils as mu
from ..core import rng
from ..pt import shading
from ..pt import visibility as VIS
from ..pt.gbuffer import GBuffer
from ..scene import envmap as EM
from ..scene import lights as LI
from . import packs
from .reservoir import LIGHT_ENV, LIGHT_INVALID, Reservoir, merge, update
from .window import window_flat

# effect seeds of the ReSTIR stages (decorrelated via hash32_combine)
EFFECT_RESTIR_INITIAL = 16
EFFECT_RESTIR_TEMPORAL = 17
EFFECT_RESTIR_SPATIAL = 18
EFFECT_RESTIR_PRESAMPLE = 19

TEMPORAL_M_CLAMP = 20.0   # RTXDI's default temporal history clamp


def _vec(t):
    return torch.stack(t, -1)


def eval_target(assets, gb: GBuffer, light, uv):
    """Unshadowed target p_hat = luminance(f * Li) of a reservoir sample at
    the pixel's surface, with the diffuse / specular contributions, the
    direction and the distance."""
    sd = gb.surface.sd
    li, direction, distance = packs.light_radiance_at(assets, sd.pos, light,
                                                      uv)
    bsdf = shading.make_wavefront_bsdf(gb.surface)
    fd, fs = (_vec(f) for f in shading.B.eval_split(
        bsdf, sd.to_local(sd.v), sd.to_local(direction)))
    contrib_d = fd * li
    contrib_s = fs * li
    p_hat = mu.luminance(contrib_d + contrib_s)
    p_hat = torch.where(gb.valid & (light != LIGHT_INVALID), p_hat, 0.0)
    return p_hat, contrib_d, contrib_s, direction, distance


class RISTiles(NamedTuple):
    """Pre-sampled candidate tiles (RtxdiPass 'Pre-sample Lights' and
    'Pre-sample Environment', RtxdiPass.cpp:297-331)."""
    pack: torch.Tensor     # (TILES*SIZE, 4) [light, u, v, 1/src_pdf]
    tiles: int
    size: int


def presample_lights(assets, sample_index: int, tiles: int = 32,
                     size: int = 256, env_fraction: float = 0.5) -> RISTiles:
    """The frame's RIS tile pool: power-sampled local lights and
    environment importance samples, interleaved."""
    lt = assets.lights
    dev = assets.env.radiance_quad.device
    count = tiles * size
    eid = torch.arange(count, dtype=torch.int64, device=dev)
    g = rng.make(eid, torch.zeros_like(eid), 0, sample_index)
    g = rng.start_effect(g, EFFECT_RESTIR_PRESAMPLE)
    g, u3 = rng.next_3d(g, allow_ld=False)
    g, u_env = rng.next_2d(g, allow_ld=False)
    stride = max(int(1.0 / max(env_fraction, 1e-3)), 1)
    is_env = (eid % stride) == 0

    d, e_pdf, _ = EM.sample_importance(assets.env, u_env)
    e_uv = mu.encode_oct(d)
    e_inv = torch.where(e_pdf > 0.0, 1.0 / torch.clamp(e_pdf, min=1e-20), 0.0)
    if lt is not None:
        li_idx = LI.pick_light(lt, u3[..., 0])
        row = LI.fetch_rows(lt, li_idx)
        src_pdf = row[..., LI.LP_POWER] / max(lt.total_power, 1e-20) \
            * row[..., LI.LP_INV_AREA]
        l_light = li_idx
        l_uv = u3[..., 1:3]
        l_inv = torch.where(src_pdf > 0.0,
                            1.0 / torch.clamp(src_pdf, min=1e-20), 0.0)
        # a candidate draws a uniform entry of a tile that interleaves env
        # and local samples: its source pdf is the mixture's, so the
        # stratum fraction is folded into the stored 1/pdf
        f_env = 1.0 / stride
        e_inv = e_inv / f_env
        l_inv = l_inv / max(1.0 - f_env, 1e-6)
    else:
        l_light = torch.full((count,), LIGHT_INVALID, dtype=torch.int32,
                             device=dev)
        l_uv = torch.zeros((count, 2), dtype=torch.float32, device=dev)
        l_inv = torch.zeros((count,), dtype=torch.float32, device=dev)
        is_env = torch.ones_like(is_env)
    light = torch.where(is_env, LIGHT_ENV, l_light)
    uv = torch.where(is_env[..., None], e_uv, l_uv)
    inv_pdf = torch.where(is_env, e_inv, l_inv)
    pack = torch.cat([light.to(torch.float32)[:, None], uv, inv_pdf[:, None]],
                     -1)
    return RISTiles(pack=pack, tiles=tiles, size=size)


def generate_candidates(assets, gb: GBuffer, px, py, sample_index: int,
                        ris: Optional[RISTiles] = None, num_local: int = 4,
                        num_env: int = 4) -> Reservoir:
    """GenerateInitialSamples.hlsl: RIS over num_local + num_env
    candidates drawn from one random tile of the pre-sampled pool; with no
    pool (`ris` None, as the ReSTIRDIInitialOutput debug view calls it),
    power-sampled local lights and environment importance samples drawn
    per pixel."""
    n = px.shape[0]
    g = rng.make(px, py, 0, sample_index)
    g = rng.start_effect(g, EFFECT_RESTIR_INITIAL)
    r = Reservoir.empty(n, px.device)
    sp = packs.pack_surface(gb)
    if ris is None:
        return _direct_candidates(assets, sp, g, r, num_local, num_env)
    g, u_tile = rng.next_1d(g, allow_ld=False)
    tile = torch.clamp((u_tile * ris.tiles).to(torch.int64),
                       max=ris.tiles - 1) * ris.size
    for _ in range(num_local + num_env):
        g, u2 = rng.next_2d(g, allow_ld=False)
        entry = tile + torch.clamp((u2[..., 0] * ris.size).to(torch.int64),
                                   max=ris.size - 1)
        row = ris.pack[entry]
        light = torch.round(row[..., 0]).to(torch.int32)
        uv = row[..., 1:3]
        p_hat = packs.surface_target_cheap(assets, sp, light, uv)
        r = update(r, light, uv, p_hat * row[..., 3], p_hat, u2[..., 1])
    return r


def _direct_candidates(assets, sp, g, r: Reservoir, num_local: int,
                       num_env: int) -> Reservoir:
    """generate_candidates without the pre-sampled pool
    (rtxpt_tpu/restir/di.py:200-239): each local candidate picks a light by
    power and a point uniform over its area (the selection pdf alone for
    delta lights), each environment candidate an importance sample."""
    lt = assets.lights
    for _ in range(num_local if lt is not None else 0):
        g, u3 = rng.next_3d(g)
        g, u_sel = rng.next_1d(g)
        light = LI.pick_light(lt, u3[..., 0])
        row = LI.fetch_rows(lt, light)
        src_pdf = row[..., LI.LP_POWER] / max(lt.total_power, 1e-20) \
            * row[..., LI.LP_INV_AREA]
        uv = u3[..., 1:3]
        p_hat = packs.surface_target_cheap(assets, sp, light, uv)
        w = torch.where(src_pdf > 0, p_hat / torch.clamp(src_pdf, min=1e-20),
                        0.0)
        r = update(r, light, uv, w, p_hat, u_sel)
    for _ in range(num_env):
        g, u2 = rng.next_2d(g)
        g, u_sel = rng.next_1d(g)
        d, pdf, _ = EM.sample_importance(assets.env, u2)
        light = torch.full_like(r.light, LIGHT_ENV)
        uv = mu.encode_oct(d)
        p_hat = packs.surface_target_cheap(assets, sp, light, uv)
        w = torch.where(pdf > 0, p_hat / torch.clamp(pdf, min=1e-20), 0.0)
        r = update(r, light, uv, w, p_hat, u_sel)
    return r


def _geometry_similar(gb: GBuffer, n_other, z_other):
    nrm_ok = torch.sum(gb.normal * n_other, -1) > 0.9
    z_ok = torch.abs(gb.view_z - z_other) < 0.1 * torch.clamp(gb.view_z,
                                                              min=1e-3)
    return gb.valid & nrm_ok & z_ok


def _reprojected(gb: GBuffer, px, py, width: int, height: int,
                 prev_y0: int, prev_rows: int):
    """(flat index of the previous frame's pixel in the window of the
    previous frame's buffers, in-bounds mask)."""
    prev_x = px.to(torch.float32) + gb.motion[..., 0]
    prev_y = py.to(torch.float32) + gb.motion[..., 1]
    in_bounds = (prev_x >= -0.5) & (prev_x < width - 0.5) & \
        (prev_y >= -0.5) & (prev_y < height - 0.5)
    flat = window_flat(torch.round(prev_x).to(torch.int64),
                       torch.round(prev_y).to(torch.int64), width, prev_y0,
                       prev_rows, height)
    return flat, in_bounds


def _tap_flat(px, py, u2, radius: float, width: int, height: int, y0: int,
              rows: int):
    off = mu.sample_disk_concentric(u2) * radius
    return window_flat(px + torch.round(off[..., 0]).to(torch.int64),
                       py + torch.round(off[..., 1]).to(torch.int64),
                       width, y0, rows, height)


def boiling_filter(w, width: int, height: int, strength: float = 8.0):
    """RTXDI boiling filter: True where a reservoir's expected radiance `w`
    exceeds `strength` x the average of its 16x16 block (zero-padded at the
    frame's edge)."""
    bs = 16
    hp = (height + bs - 1) // bs * bs
    wp = (width + bs - 1) // bs * bs
    img = torch.nn.functional.pad(w.reshape(height, width),
                                  (0, wp - width, 0, hp - height))
    avg = img.reshape(hp // bs, bs, wp // bs, bs).mean(dim=(1, 3))
    avg_img = avg.repeat_interleave(bs, 0).repeat_interleave(bs, 1)
    avg_img = avg_img[:height, :width].reshape(-1)
    return w > strength * torch.clamp(avg_img, min=1e-6)


def temporal_resample(assets, gb: GBuffer, cur: Reservoir, prev: Reservoir,
                      prev_normal, prev_view_z, px, py, width: int,
                      height: int, sample_index: int, y0: int = 0,
                      rows: int = None, prev_y0: int = 0,
                      prev_rows: int = None) -> Reservoir:
    """TemporalResampling.hlsl: reproject with the motion vectors, validate
    the geometry, clamp the history M, merge, boiling filter.

    y0/rows: the row window of the current buffers (row-sharded stage 1,
    models/realtime.py `Window`); prev_y0/prev_rows: the window of the
    previous frame's buffers, which carry halo rows
    (parallel/meshutils.exchange_prev_halos). The defaults are the whole
    frame."""
    rows = height if rows is None else rows
    prev_rows = height if prev_rows is None else prev_rows
    g = rng.make(px, py, 0, sample_index)
    g = rng.start_effect(g, EFFECT_RESTIR_TEMPORAL)
    g, u = rng.next_1d(g)
    flat, in_bounds = _reprojected(gb, px, py, width, height, prev_y0,
                                   prev_rows)
    trows = torch.cat([packs.pack_reservoir(prev), prev_normal,
                       prev_view_z[..., None]], -1)[flat]
    pr = packs.unpack_reservoir(trows)
    sim = _geometry_similar(gb, trows[..., 8:11], trows[..., 11]) & in_bounds
    m_clamped = torch.minimum(pr.m, TEMPORAL_M_CLAMP
                              * torch.clamp(cur.m, min=1.0))
    pr = pr._replace(m=torch.where(sim, m_clamped, 0.0),
                     light=torch.where(sim, pr.light, LIGHT_INVALID))
    p_hat = packs.surface_target_cheap(assets, packs.pack_surface(gb),
                                       pr.light, pr.uv)
    out = merge(cur, pr, p_hat, u)
    boiling = boiling_filter(out.contribution_weight() * out.target, width,
                             rows)
    return out._replace(light=torch.where(boiling, LIGHT_INVALID, out.light),
                        w_sum=torch.where(boiling, 0.0, out.w_sum),
                        target=torch.where(boiling, 0.0, out.target))


def spatial_resample(assets, gb: GBuffer, cur: Reservoir, px, py,
                     width: int, height: int, sample_index: int,
                     taps: int = 2, radius: float = 20.0, y0: int = 0,
                     rows: int = None) -> Reservoir:
    """SpatialResampling.hlsl with RTXDI's pairwise MIS: each neighbour
    stream i is paired with the canonical (centre) stream c,

        m_i(y_i) = p_i(y_i) M_i / (p_i(y_i) M_i + p_c(y_i) M_c / k)
        m_c      = (1/k) sum_i p_c(y_c) M_c / (p_i(y_c) M_i + p_c(y_c) M_c/k)

    (a rejected neighbour cedes its 1/k share to the canonical stream).
    Generalized RIS gives W = w_sum / p_hat(y); w_sum is stored times M so
    that contribution_weight(), which divides by M, still holds.

    y0/rows: the row window of the current buffers; the taps clamp to its
    rows (the default window is the whole frame)."""
    rows = height if rows is None else rows
    n = px.shape[0]
    g = rng.make(px, py, 0, sample_index)
    g = rng.start_effect(g, EFFECT_RESTIR_SPATIAL)
    k = float(taps)
    eps = 1e-20
    m_c = torch.clamp(cur.m, min=1e-3)
    ph_cc = cur.target
    w_canon_share = ph_cc * m_c / k
    sp = packs.pack_surface(gb)
    rows_all = torch.cat([packs.pack_reservoir(cur), sp], -1)
    r = Reservoir.empty(n, px.device)
    ris_sum = torch.zeros((n,), dtype=torch.float32, device=px.device)
    mc_acc = torch.zeros_like(ris_sum)
    m_total = cur.m
    for _ in range(taps):
        g, u2 = rng.next_2d(g)
        g, u = rng.next_1d(g)
        trows = rows_all[_tap_flat(px, py, u2, radius, width, height, y0,
                                   rows)]
        nb = packs.unpack_reservoir(trows[..., :8])
        sim = _geometry_similar(gb, trows[..., 8 + 3:8 + 6],
                                trows[..., 8 + 9]) & \
            (nb.light != LIGHT_INVALID)
        ph_ci = packs.surface_target_cheap(assets, sp, nb.light, nb.uv)
        ph_ic = packs.surface_target_cheap(assets, trows[..., 8:24],
                                           cur.light, cur.uv)
        ph_ii = nb.target
        mi = torch.where(sim, ph_ii * nb.m / torch.clamp(
            ph_ii * nb.m + ph_ci * m_c / k, min=eps), 0.0)
        w_i = torch.where(sim, mi * ph_ci * nb.contribution_weight(), 0.0)
        ris_sum = ris_sum + w_i
        take = (u * ris_sum < w_i) & (w_i > 0.0)
        r = Reservoir(light=torch.where(take, nb.light, r.light),
                      uv=torch.where(take[..., None], nb.uv, r.uv),
                      w_sum=ris_sum, m=r.m,
                      target=torch.where(take, ph_ci, r.target))
        mc_acc = mc_acc + torch.where(
            sim, w_canon_share / torch.clamp(ph_ic * nb.m + w_canon_share,
                                             min=eps), 1.0 / k)
        m_total = m_total + torch.where(sim, nb.m, 0.0)

    # the canonical stream last
    g, u = rng.next_1d(g)
    w_c = mc_acc * ph_cc * cur.contribution_weight()
    ris_sum = ris_sum + w_c
    take = (u * ris_sum < w_c) & (w_c > 0.0)
    m_out = torch.clamp(m_total, min=1e-3)
    return Reservoir(
        light=torch.where(ris_sum > 0.0, torch.where(take, cur.light,
                                                     r.light),
                          LIGHT_INVALID),
        uv=torch.where(take[..., None], cur.uv, r.uv),
        w_sum=ris_sum * m_out, m=m_out,
        target=torch.where(take, ph_cc, r.target))


def final_shade(assets, gb: GBuffer, r: Reservoir, exact_alpha=False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DIFinalShading.hlsl: visibility ray + weighted contribution;
    returns the (diffuse, specular) DI radiance. exact_alpha: the
    visibility ray's exact alpha test (PTConfig.exact_alpha_test)."""
    p_hat, cd, cs, direction, distance = eval_target(assets, gb, r.light,
                                                     r.uv)
    w = r.contribution_weight()
    need = gb.valid & (w > 0.0) & (p_hat > 0.0)
    origin = gb.surface.sd.compute_new_ray_origin(torch.ones_like(need))
    occluded = VIS.trace_visibility(assets, origin, direction,
                                    t_max=distance * (1.0 - 1e-4),
                                    active=need, exact=exact_alpha)
    scale = torch.where(need & ~occluded, w, 0.0)[..., None]
    return cd * scale, cs * scale


def fused_final_shade(assets, gb: GBuffer, r_di: Reservoir, r_gi,
                      exact_alpha=False):
    """Fused DI + GI final shading (RtxdiPass::ExecuteFusedDIGIFinal,
    RtxdiPass.cpp:533): both reservoirs' visibility rays go through one
    any-hit trace of 2N lanes. Returns (di_d, di_s, gi_d, gi_s)."""
    from . import gi as GI
    n = gb.valid.shape[0]
    p_di, cd_d, cs_d, dir_d, dist_d = eval_target(assets, gb, r_di.light,
                                                  r_di.uv)
    w_d = r_di.contribution_weight()
    need_d = gb.valid & (w_d > 0.0) & (p_di > 0.0)
    p_gi, cd_g, cs_g, dir_g, dist_g = GI.eval_target(
        gb, r_gi.pos, r_gi.radiance, r_gi.valid)
    w_g = r_gi.contribution_weight()
    need_g = gb.valid & (w_g > 0.0) & (p_gi > 0.0)
    origin = gb.surface.sd.compute_new_ray_origin(torch.ones_like(need_d))
    occluded = VIS.trace_visibility(
        assets, torch.cat([origin, origin], 0), torch.cat([dir_d, dir_g], 0),
        t_max=torch.cat([dist_d * (1.0 - 1e-4),
                         torch.clamp(dist_g - 1e-3, min=1e-4)], 0),
        active=torch.cat([need_d, need_g], 0), exact=exact_alpha)
    s_d = torch.where(need_d & ~occluded[:n], w_d, 0.0)[..., None]
    s_g = torch.where(need_g & ~occluded[n:], w_g, 0.0)[..., None]
    return cd_d * s_d, cs_d * s_d, cd_g * s_g, cs_g * s_g
