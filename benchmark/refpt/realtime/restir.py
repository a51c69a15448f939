"""ReSTIR DI and GI of the realtime frame (counterparts of the port's
restir/reservoir.py, packs.py, window.py, di.py and gi.py; RTXDI's
GenerateInitialSamples, TemporalResampling, SpatialResampling,
DIFinalShading and the GI passes), the arithmetic copied as it stands.

Two departures in form, none in arithmetic, so that the passes run at any
set of pixels:

- the temporal passes stop before the boiling filter (`*_temporal` return
  the merged reservoir), and `boil_di` / `boil_gi` apply the filter given
  the 16x16 block means (`block_means`) of the frame;
- the spatial passes read their neighbours through `rows_at(flat)`, a
  function that returns the packed rows (reservoir and surface) of frame
  pixels by flat index, where the port gathers them from the frame's own
  buffers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import mathutils as mu
from ..core import rng
from ..ops import traverse
from ..pt import bsdf as B
from ..scene import envmap as EM
from ..scene import lights as LI
from .extra import (decode_oct, encode_oct, eval_sample_at, eval_split,
                    make_wavefront_bsdf)

LIGHT_INVALID = -1
LIGHT_ENV = -2
EFFECT_RESTIR_INITIAL = 16
EFFECT_RESTIR_TEMPORAL = 17
EFFECT_RESTIR_SPATIAL = 18
EFFECT_RESTIR_PRESAMPLE = 19
EFFECT_RESTIR_GI_TEMPORAL = 24
EFFECT_RESTIR_GI_SPATIAL = 25
TEMPORAL_M_CLAMP = 20.0
GI_TEMPORAL_M_CLAMP = 30.0
BOIL_BLOCK = 16
BOIL_STRENGTH = 8.0


# ---- reservoirs (restir/reservoir.py, gi.GIReservoir) ------------------

class Reservoir(NamedTuple):
    light: torch.Tensor   # (N,) i32
    uv: torch.Tensor      # (N,2) f32
    w_sum: torch.Tensor   # (N,)
    m: torch.Tensor       # (N,)
    target: torch.Tensor  # (N,) p_hat of the stored sample

    @staticmethod
    def empty(n: int, device) -> "Reservoir":
        z = torch.zeros((n,), dtype=torch.float32, device=device)
        return Reservoir(
            light=torch.full((n,), LIGHT_INVALID, dtype=torch.int32,
                             device=device),
            uv=torch.zeros((n, 2), dtype=torch.float32, device=device),
            w_sum=z, m=z, target=z)

    def contribution_weight(self):
        denom = self.m * self.target
        return torch.where((self.light != LIGHT_INVALID) & (denom > 0.0),
                           self.w_sum / torch.clamp(denom, min=1e-20), 0.0)


class GIReservoir(NamedTuple):
    pos: torch.Tensor        # (N,3) secondary sample position
    normal: torch.Tensor     # (N,3) secondary surface normal (geometric)
    radiance: torch.Tensor   # (N,3) Lo toward the receiver
    w_sum: torch.Tensor      # (N,)
    m: torch.Tensor          # (N,)
    target: torch.Tensor     # (N,) p_hat of the stored sample
    valid: torch.Tensor      # (N,) bool sample exists

    def contribution_weight(self):
        denom = self.m * self.target
        return torch.where(self.valid & (denom > 0.0),
                           self.w_sum / torch.clamp(denom, min=1e-20), 0.0)


def update(r: Reservoir, light, uv, weight, target, u,
           count=1.0) -> Reservoir:
    w_sum = r.w_sum + weight
    take = (u * w_sum < weight) & (weight > 0.0)
    return Reservoir(
        light=torch.where(take, light, r.light),
        uv=torch.where(take[..., None], uv, r.uv),
        w_sum=w_sum, m=r.m + count,
        target=torch.where(take, target, r.target))


def merge(r: Reservoir, other: Reservoir, other_target_at_center,
          u) -> Reservoir:
    w_in = other_target_at_center * other.contribution_weight() * other.m
    return update(r, other.light, other.uv, w_in, other_target_at_center, u,
                  count=other.m)


# ---- packs (restir/packs.py, window.py) ---------------------------------

S_POS = slice(0, 3)
S_NRM = slice(3, 6)
S_V = slice(6, 9)
S_ALPHA = 10
S_LDIFF = 11
S_LSPEC = 12
S_TRANS = 13
S_LTRANS = 14
S_VALID = 15


def pack_surface(gb) -> torch.Tensor:
    """(N,16) resampling-surface rows of a GBuffer."""
    sd = gb.surface.sd
    b = make_wavefront_bsdf(gb.surface)
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
    from world position `pos`."""
    lt = assets.lights
    is_env = light == LIGHT_ENV
    n = light.shape[0]
    if lt is not None:
        dir_local, dist_local, li_v, _, l_ok = eval_sample_at(
            lt, torch.clamp(light, min=0), uv, pos)
        li_v = torch.where(l_ok[..., None], li_v, 0.0)
    else:
        dir_local = torch.zeros((n, 3), dtype=torch.float32,
                                device=pos.device)
        dist_local = torch.zeros((n,), dtype=torch.float32, device=pos.device)
        li_v = torch.zeros_like(dir_local)
    dir_env = decode_oct(uv)
    li_env = EM.eval_dir(assets.env, dir_env)
    direction = torch.where(is_env[..., None], dir_env, dir_local)
    distance = torch.where(is_env, mu.K_MAX_RAY_TRAVEL, dist_local)
    li = torch.where(is_env[..., None], li_env, li_v)
    return li, direction, distance


def _cheap_brdf(sp, direction):
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
    li, direction, _ = light_radiance_at(assets, sp[..., S_POS], light, uv)
    p_hat = mu.luminance(li) * _cheap_brdf(sp, direction)
    return torch.where((sp[..., S_VALID] > 0.5) & (light != LIGHT_INVALID),
                       p_hat, 0.0)


def gi_target_cheap(sp, pos, radiance, valid):
    to_s = pos - sp[..., S_POS]
    dist_sq = torch.clamp(torch.sum(to_s * to_s, -1), min=1e-9)
    direction = to_s / torch.sqrt(dist_sq)[..., None]
    p_hat = mu.luminance(radiance) * _cheap_brdf(sp, direction)
    return torch.where((sp[..., S_VALID] > 0.5) & valid, p_hat, 0.0)


def pack_reservoir(r: Reservoir) -> torch.Tensor:
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
    n = r.w_sum.shape[0]
    return torch.cat([
        r.pos, r.normal, r.radiance, r.w_sum[..., None], r.m[..., None],
        r.target[..., None], r.valid.to(torch.float32)[..., None],
        torch.zeros((n, 1), dtype=torch.float32, device=r.pos.device)], -1)


def unpack_gi_reservoir(rows):
    return GIReservoir(pos=rows[..., 0:3], normal=rows[..., 3:6],
                       radiance=rows[..., 6:9], w_sum=rows[..., 9],
                       m=rows[..., 10], target=rows[..., 11],
                       valid=rows[..., 12] > 0.5)


def window_flat(ix, iy, width: int, height: int):
    """Flat frame index of (ix, iy) clamped into the frame."""
    return torch.clamp(iy, 0, height - 1) * width + torch.clamp(ix, 0,
                                                                 width - 1)


def _reprojected(gb, px, py, width: int, height: int):
    prev_x = px.to(torch.float32) + gb.motion[..., 0]
    prev_y = py.to(torch.float32) + gb.motion[..., 1]
    in_bounds = (prev_x >= -0.5) & (prev_x < width - 0.5) & \
        (prev_y >= -0.5) & (prev_y < height - 0.5)
    flat = window_flat(torch.round(prev_x).to(torch.int64),
                       torch.round(prev_y).to(torch.int64), width, height)
    return flat, in_bounds


def _tap_flat(px, py, u2, radius: float, width: int, height: int):
    off = mu.sample_disk_concentric(u2) * radius
    return window_flat(px + torch.round(off[..., 0]).to(torch.int64),
                       py + torch.round(off[..., 1]).to(torch.int64),
                       width, height)


def block_index(px, py, width: int):
    """The 16x16 block of each pixel, row-major over the padded frame."""
    bw = (width + BOIL_BLOCK - 1) // BOIL_BLOCK
    return (py // BOIL_BLOCK) * bw + px // BOIL_BLOCK


def boiling(values, means, px, py, width: int):
    """True where a reservoir's expected radiance exceeds BOIL_STRENGTH x
    the mean of its block."""
    avg = means[block_index(px, py, width)]
    return values > BOIL_STRENGTH * torch.clamp(avg, min=1e-6)


def _geometry_similar(gb, n_other, z_other):
    nrm_ok = torch.sum(gb.normal * n_other, -1) > 0.9
    z_ok = torch.abs(gb.view_z - z_other) < 0.1 * torch.clamp(gb.view_z,
                                                              min=1e-3)
    return gb.valid & nrm_ok & z_ok


# ---- ReSTIR DI (restir/di.py) -------------------------------------------

class RISTiles(NamedTuple):
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
    e_uv = encode_oct(d)
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


def di_candidates(assets, gb, px, py, sample_index: int, ris: RISTiles,
                  num_local: int = 4, num_env: int = 4) -> Reservoir:
    """GenerateInitialSamples.hlsl: RIS over num_local + num_env
    candidates drawn from one random tile of the pre-sampled pool."""
    n = px.shape[0]
    g = rng.make(px, py, 0, sample_index)
    g = rng.start_effect(g, EFFECT_RESTIR_INITIAL)
    r = Reservoir.empty(n, px.device)
    sp = pack_surface(gb)
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
        p_hat = surface_target_cheap(assets, sp, light, uv)
        r = update(r, light, uv, p_hat * row[..., 3], p_hat, u2[..., 1])
    return r


def di_temporal(assets, gb, cur: Reservoir, prev: Reservoir, prev_normal,
                prev_view_z, px, py, width: int, height: int,
                sample_index: int) -> Reservoir:
    """TemporalResampling.hlsl up to the boiling filter: reproject,
    validate the geometry, clamp the history M, merge. `prev`,
    prev_normal and prev_view_z are the previous frame's full-frame
    buffers."""
    g = rng.make(px, py, 0, sample_index)
    g = rng.start_effect(g, EFFECT_RESTIR_TEMPORAL)
    g, u = rng.next_1d(g)
    flat, in_bounds = _reprojected(gb, px, py, width, height)
    pr = Reservoir(*(a[flat] for a in prev))
    sim = _geometry_similar(gb, prev_normal[flat], prev_view_z[flat]) & \
        in_bounds
    m_clamped = torch.minimum(pr.m, TEMPORAL_M_CLAMP
                              * torch.clamp(cur.m, min=1.0))
    pr = pr._replace(m=torch.where(sim, m_clamped, 0.0),
                     light=torch.where(sim, pr.light, LIGHT_INVALID))
    p_hat = surface_target_cheap(assets, pack_surface(gb), pr.light, pr.uv)
    return merge(cur, pr, p_hat, u)


def di_boil_value(r: Reservoir):
    return r.contribution_weight() * r.target


def boil_di(r: Reservoir, boiled) -> Reservoir:
    return r._replace(light=torch.where(boiled, LIGHT_INVALID, r.light),
                      w_sum=torch.where(boiled, 0.0, r.w_sum),
                      target=torch.where(boiled, 0.0, r.target))


def di_neighbour_rows(feedback: Reservoir, surface_rows):
    """(N, 24) packed neighbour rows of the DI spatial pass: the temporal
    feedback reservoir and the surface pack (pack_surface)."""
    return torch.cat([pack_reservoir(feedback), surface_rows], -1)


def di_spatial(assets, gb, cur: Reservoir, px, py, width: int, height: int,
               sample_index: int, rows_at, taps: int = 2,
               radius: float = 20.0) -> Reservoir:
    """SpatialResampling.hlsl with RTXDI's pairwise MIS (the port's
    di.spatial_resample); `rows_at(flat)` gives the neighbours'
    di_neighbour_rows."""
    n = px.shape[0]
    g = rng.make(px, py, 0, sample_index)
    g = rng.start_effect(g, EFFECT_RESTIR_SPATIAL)
    k = float(taps)
    eps = 1e-20
    m_c = torch.clamp(cur.m, min=1e-3)
    ph_cc = cur.target
    w_canon_share = ph_cc * m_c / k
    sp = pack_surface(gb)
    r = Reservoir.empty(n, px.device)
    ris_sum = torch.zeros((n,), dtype=torch.float32, device=px.device)
    mc_acc = torch.zeros_like(ris_sum)
    m_total = cur.m
    for _ in range(taps):
        g, u2 = rng.next_2d(g)
        g, u = rng.next_1d(g)
        trows = rows_at(_tap_flat(px, py, u2, radius, width, height))
        nb = unpack_reservoir(trows[..., :8])
        sim = _geometry_similar(gb, trows[..., 8 + 3:8 + 6],
                                trows[..., 8 + 9]) & \
            (nb.light != LIGHT_INVALID)
        ph_ci = surface_target_cheap(assets, sp, nb.light, nb.uv)
        ph_ic = surface_target_cheap(assets, trows[..., 8:24], cur.light,
                                     cur.uv)
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


def eval_di_target(assets, gb, light, uv):
    sd = gb.surface.sd
    li, direction, distance = light_radiance_at(assets, sd.pos, light, uv)
    bsdf = make_wavefront_bsdf(gb.surface)
    fd, fs = (torch.stack(f, -1) for f in eval_split(
        bsdf, sd.to_local(sd.v), sd.to_local(direction)))
    contrib_d = fd * li
    contrib_s = fs * li
    p_hat = mu.luminance(contrib_d + contrib_s)
    p_hat = torch.where(gb.valid & (light != LIGHT_INVALID), p_hat, 0.0)
    return p_hat, contrib_d, contrib_s, direction, distance


# ---- ReSTIR GI (restir/gi.py) -------------------------------------------

def eval_gi_target(gb, pos, radiance, valid):
    sd = gb.surface.sd
    to_s = pos - sd.pos
    dist_sq = torch.clamp(torch.sum(to_s * to_s, -1), min=1e-9)
    dist = torch.sqrt(dist_sq)
    direction = to_s / dist[..., None]
    bsdf = make_wavefront_bsdf(gb.surface)
    fd, fs = (torch.stack(f, -1) for f in eval_split(
        bsdf, sd.to_local(sd.v), sd.to_local(direction)))
    cd = fd * radiance
    cs = fs * radiance
    p_hat = torch.where(gb.valid & valid, mu.luminance(cd + cs), 0.0)
    return p_hat, cd, cs, direction, dist


def _jacobian(gb_pos, sample: GIReservoir, src_receiver_pos):
    def geo(recv):
        v = sample.pos - recv
        d2 = torch.clamp(torch.sum(v * v, -1), min=1e-9)
        cosv = torch.abs(torch.sum(sample.normal * (-v)
                                   / torch.sqrt(d2)[..., None], -1))
        return torch.clamp(cosv, min=1e-4) / d2
    return geo(gb_pos) / geo(src_receiver_pos)


def gi_initial(gb, sec_pos, sec_normal, sec_found, lo,
               src_pdf) -> GIReservoir:
    p_hat = gi_target_cheap(pack_surface(gb), sec_pos, lo, sec_found)
    w = torch.where(sec_found & (src_pdf > 0.0),
                    p_hat / torch.clamp(src_pdf, min=1e-20), 0.0)
    return GIReservoir(pos=sec_pos, normal=sec_normal, radiance=lo,
                       w_sum=w, m=torch.ones_like(w), target=p_hat,
                       valid=sec_found)


def _gi_merge(r: GIReservoir, other: GIReservoir, p_hat_center, jac,
              u) -> GIReservoir:
    w_in = p_hat_center * other.contribution_weight() * other.m * jac
    w_sum = r.w_sum + w_in
    take = (u * w_sum < w_in) & (w_in > 0.0)
    t3 = take[..., None]
    return GIReservoir(
        pos=torch.where(t3, other.pos, r.pos),
        normal=torch.where(t3, other.normal, r.normal),
        radiance=torch.where(t3, other.radiance, r.radiance),
        w_sum=w_sum, m=r.m + other.m,
        target=torch.where(take, p_hat_center, r.target),
        valid=r.valid | (take & other.valid))


def gi_temporal(gb, cur: GIReservoir, prev: GIReservoir, prev_normal,
                prev_z, px, py, width: int, height: int,
                frame: int) -> GIReservoir:
    """GITemporalResampling.hlsl up to the boiling filter."""
    g = rng.make(px, py, 0, frame)
    g = rng.start_effect(g, EFFECT_RESTIR_GI_TEMPORAL)
    g, u = rng.next_1d(g)
    flat, in_b = _reprojected(gb, px, py, width, height)
    pr = GIReservoir(*(a[flat] for a in prev))
    sim = in_b & _geometry_similar(gb, prev_normal[flat], prev_z[flat])
    pr = pr._replace(m=torch.where(sim, torch.clamp(
        pr.m, max=GI_TEMPORAL_M_CLAMP), 0.0), valid=pr.valid & sim)
    p_hat = gi_target_cheap(pack_surface(gb), pr.pos, pr.radiance, pr.valid)
    return _gi_merge(cur, pr, p_hat, torch.ones_like(p_hat), u)


def gi_boil_value(r: GIReservoir):
    return r.contribution_weight() * r.target


def boil_gi(r: GIReservoir, boiled) -> GIReservoir:
    return r._replace(valid=r.valid & ~boiled,
                      w_sum=torch.where(boiled, 0.0, r.w_sum),
                      target=torch.where(boiled, 0.0, r.target))


def gi_neighbour_rows(feedback: GIReservoir, gb):
    """(N, 21) packed neighbour rows of the GI spatial pass: the temporal
    feedback reservoir, the surface position, normal and view depth."""
    return torch.cat([pack_gi_reservoir(feedback), gb.pos, gb.normal,
                      gb.view_z[..., None]], -1)


def gi_spatial(gb, cur: GIReservoir, px, py, width: int, height: int,
               frame: int, rows_at, taps: int = 2,
               radius: float = 16.0) -> GIReservoir:
    """GISpatialResampling.hlsl (the port's gi.spatial_resample);
    `rows_at(flat)` gives the neighbours' gi_neighbour_rows."""
    g = rng.make(px, py, 0, frame)
    g = rng.start_effect(g, EFFECT_RESTIR_GI_SPATIAL)
    r = cur
    sp = pack_surface(gb)
    for _ in range(taps):
        g, u2 = rng.next_2d(g)
        g, u = rng.next_1d(g)
        trows = rows_at(_tap_flat(px, py, u2, radius, width, height))
        nb = unpack_gi_reservoir(trows[..., :14])
        sim = _geometry_similar(gb, trows[..., 17:20], trows[..., 20])
        nb = nb._replace(m=torch.where(sim, nb.m, 0.0), valid=nb.valid & sim)
        p_hat = gi_target_cheap(sp, nb.pos, nb.radiance, nb.valid)
        jac = torch.clamp(_jacobian(gb.pos, nb, trows[..., 14:17]), 0.0,
                          10.0)
        r = _gi_merge(r, nb, p_hat, jac, u)
    return r


# ---- the fused DI + GI final shading (di.fused_final_shade) -------------

def fused_final_shade(assets, gb, r_di: Reservoir, r_gi: GIReservoir):
    """Both reservoirs' visibility rays through one any-hit trace of 2N
    lanes. Returns (di_d, di_s, gi_d, gi_s)."""
    n = gb.valid.shape[0]
    p_di, cd_d, cs_d, dir_d, dist_d = eval_di_target(assets, gb, r_di.light,
                                                     r_di.uv)
    w_d = r_di.contribution_weight()
    need_d = gb.valid & (w_d > 0.0) & (p_di > 0.0)
    p_gi, cd_g, cs_g, dir_g, dist_g = eval_gi_target(
        gb, r_gi.pos, r_gi.radiance, r_gi.valid)
    w_g = r_gi.contribution_weight()
    need_g = gb.valid & (w_g > 0.0) & (p_gi > 0.0)
    origin = gb.surface.sd.compute_new_ray_origin(torch.ones_like(need_d))
    occluded = traverse.trace_anyhit(
        assets.accel, torch.cat([origin, origin], 0),
        torch.cat([dir_d, dir_g], 0),
        t_max=torch.cat([dist_d * (1.0 - 1e-4),
                         torch.clamp(dist_g - 1e-3, min=1e-4)], 0),
        active=torch.cat([need_d, need_g], 0))
    s_d = torch.where(need_d & ~occluded[:n], w_d, 0.0)[..., None]
    s_g = torch.where(need_g & ~occluded[n:], w_g, 0.0)[..., None]
    return cd_d * s_d, cs_d * s_d, cd_g * s_g, cs_g * s_g
