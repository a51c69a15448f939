"""ReSTIR GI: secondary-surface reservoir resampling for indirect light
(counterpart of rtxpt_tpu/restir/gi.py; GITemporalResampling.hlsl,
GISpatialResampling.hlsl, GIFinalShading.hlsl; the secondary surface is
exported by the path tracer, Sample.hlsl:279).

A GI reservoir stores one secondary-surface sample per pixel: the world
position and normal of the first bounce hit and its outgoing radiance Lo
toward the primary surface. The target at a receiving pixel is
p_hat = luminance(f(primary -> sample) * Lo); spatial reuse applies the
solid-angle Jacobian of reconnecting the sample to another receiver
(Ouyang et al. 2021, eq. 11).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core import mathutils as mu
from ..core import rng
from ..pt import shading
from ..pt import visibility as VIS
from ..pt.gbuffer import GBuffer
from . import packs
from .di import _reprojected, _tap_flat, boiling_filter

EFFECT_RESTIR_GI_TEMPORAL = 24
EFFECT_RESTIR_GI_SPATIAL = 25

GI_TEMPORAL_M_CLAMP = 30.0


class GIReservoir(NamedTuple):
    pos: torch.Tensor        # (N,3) secondary sample position
    normal: torch.Tensor     # (N,3) secondary surface normal (geometric)
    radiance: torch.Tensor   # (N,3) Lo toward the receiver
    w_sum: torch.Tensor      # (N,)
    m: torch.Tensor          # (N,)
    target: torch.Tensor     # (N,) p_hat of the stored sample
    valid: torch.Tensor      # (N,) bool sample exists

    @staticmethod
    def empty(n: int, device) -> "GIReservoir":
        z3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
        z1 = torch.zeros((n,), dtype=torch.float32, device=device)
        return GIReservoir(z3, z3, z3, z1, z1, z1,
                           torch.zeros((n,), dtype=torch.bool, device=device))

    def contribution_weight(self):
        denom = self.m * self.target
        return torch.where(self.valid & (denom > 0.0),
                           self.w_sum / torch.clamp(denom, min=1e-20), 0.0)


def eval_target(gb: GBuffer, pos, radiance, valid):
    """p_hat = luminance(f * cos * Lo) at the receiving pixel; returns
    (p_hat, f_diff * Lo, f_spec * Lo, direction, distance)."""
    sd = gb.surface.sd
    to_s = pos - sd.pos
    dist_sq = torch.clamp(torch.sum(to_s * to_s, -1), min=1e-9)
    dist = torch.sqrt(dist_sq)
    direction = to_s / dist[..., None]
    bsdf = shading.make_wavefront_bsdf(gb.surface)
    fd, fs = (torch.stack(f, -1) for f in shading.B.eval_split(
        bsdf, sd.to_local(sd.v), sd.to_local(direction)))
    cd = fd * radiance
    cs = fs * radiance
    p_hat = torch.where(gb.valid & valid, mu.luminance(cd + cs), 0.0)
    return p_hat, cd, cs, direction, dist


def _jacobian(gb_pos, sample: GIReservoir, src_receiver_pos):
    """Solid-angle reconnection Jacobian |J(q -> r)| (ReSTIR GI eq. 11)."""
    def geo(recv):
        v = sample.pos - recv
        d2 = torch.clamp(torch.sum(v * v, -1), min=1e-9)
        cosv = torch.abs(torch.sum(sample.normal * (-v)
                                   / torch.sqrt(d2)[..., None], -1))
        return torch.clamp(cosv, min=1e-4) / d2
    return geo(gb_pos) / geo(src_receiver_pos)


def make_initial(gb: GBuffer, sec_pos, sec_normal, sec_found, lo,
                 src_pdf) -> GIReservoir:
    """The path-traced secondary sample as a one-candidate reservoir (its
    source pdf is the primary BSDF sampling pdf, in solid angle)."""
    p_hat = packs.gi_target_cheap(packs.pack_surface(gb), sec_pos, lo,
                                  sec_found)
    w = torch.where(sec_found & (src_pdf > 0.0),
                    p_hat / torch.clamp(src_pdf, min=1e-20), 0.0)
    return GIReservoir(pos=sec_pos, normal=sec_normal, radiance=lo,
                       w_sum=w, m=torch.ones_like(w), target=p_hat,
                       valid=sec_found)


def _merge(r: GIReservoir, other: GIReservoir, p_hat_center, jac,
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


def _similar(gb: GBuffer, n_other, z_other):
    return gb.valid & (torch.sum(gb.normal * n_other, -1) > 0.9) & \
        (torch.abs(gb.view_z - z_other)
         < 0.1 * torch.clamp(gb.view_z, min=1e-3))


def temporal_resample(gb: GBuffer, cur: GIReservoir, prev: GIReservoir,
                      prev_normal, prev_z, px, py, width: int, height: int,
                      frame: int, y0: int = 0, rows: int = None,
                      prev_y0: int = 0, prev_rows: int = None
                      ) -> GIReservoir:
    """GITemporalResampling.hlsl: reprojection, geometry test, history
    clamp, merge (same-point reconnection: Jacobian 1), boiling filter.
    Row windows as in di.temporal_resample."""
    rows = height if rows is None else rows
    prev_rows = height if prev_rows is None else prev_rows
    g = rng.make(px, py, 0, frame)
    g = rng.start_effect(g, EFFECT_RESTIR_GI_TEMPORAL)
    g, u = rng.next_1d(g)
    flat, in_b = _reprojected(gb, px, py, width, height, prev_y0, prev_rows)
    trows = torch.cat([packs.pack_gi_reservoir(prev), prev_normal,
                       prev_z[..., None]], -1)[flat]
    pr = packs.unpack_gi_reservoir(trows[..., :14])
    sim = in_b & _similar(gb, trows[..., 14:17], trows[..., 17])
    pr = pr._replace(m=torch.where(sim, torch.clamp(
        pr.m, max=GI_TEMPORAL_M_CLAMP), 0.0), valid=pr.valid & sim)
    p_hat = packs.gi_target_cheap(packs.pack_surface(gb), pr.pos,
                                  pr.radiance, pr.valid)
    r = _merge(cur, pr, p_hat, torch.ones_like(p_hat), u)
    boiling = boiling_filter(r.contribution_weight() * r.target, width,
                             rows)
    return r._replace(valid=r.valid & ~boiling,
                      w_sum=torch.where(boiling, 0.0, r.w_sum),
                      target=torch.where(boiling, 0.0, r.target))


def spatial_resample(gb: GBuffer, cur: GIReservoir, px, py, width: int,
                     height: int, frame: int, taps: int = 2,
                     radius: float = 16.0, y0: int = 0,
                     rows: int = None) -> GIReservoir:
    """GISpatialResampling.hlsl: merge neighbours that pass the geometry
    test, each weighted by its reconnection Jacobian (clamped to 10). The
    taps clamp to the row window y0/rows (default: the whole frame)."""
    rows = height if rows is None else rows
    g = rng.make(px, py, 0, frame)
    g = rng.start_effect(g, EFFECT_RESTIR_GI_SPATIAL)
    r = cur
    sp = packs.pack_surface(gb)
    rows_all = torch.cat([packs.pack_gi_reservoir(cur), gb.pos, gb.normal,
                          gb.view_z[..., None]], -1)
    for _ in range(taps):
        g, u2 = rng.next_2d(g)
        g, u = rng.next_1d(g)
        trows = rows_all[_tap_flat(px, py, u2, radius, width, height, y0,
                                   rows)]
        nb = packs.unpack_gi_reservoir(trows[..., :14])
        sim = _similar(gb, trows[..., 17:20], trows[..., 20])
        nb = nb._replace(m=torch.where(sim, nb.m, 0.0), valid=nb.valid & sim)
        p_hat = packs.gi_target_cheap(sp, nb.pos, nb.radiance, nb.valid)
        jac = torch.clamp(_jacobian(gb.pos, nb, trows[..., 14:17]), 0.0,
                          10.0)
        r = _merge(r, nb, p_hat, jac, u)
    return r


def final_shade(assets, gb: GBuffer, r: GIReservoir, exact_alpha=False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GIFinalShading.hlsl: reconnection visibility + weighted shade.
    exact_alpha: the ray's exact alpha test (PTConfig.exact_alpha_test)."""
    p_hat, cd, cs, direction, dist = eval_target(gb, r.pos, r.radiance,
                                                 r.valid)
    w = r.contribution_weight()
    need = gb.valid & (w > 0.0) & (p_hat > 0.0)
    origin = gb.surface.sd.compute_new_ray_origin(torch.ones_like(need))
    occluded = VIS.trace_visibility(assets, origin, direction,
                                    t_max=torch.clamp(dist - 1e-3, min=1e-4),
                                    active=need, exact=exact_alpha)
    scale = torch.where(need & ~occluded, w, 0.0)[..., None]
    return cd * scale, cs * scale
