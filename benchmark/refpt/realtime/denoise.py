"""ReLAX and TAA of the realtime frame (counterparts of the port's
denoise/relax.py and post/taa.py), copied whole: the temporal
accumulation, variance estimate and a-trous passes of one channel, and
the Catmull-Rom TAA resolve with its variance clip."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import mathutils as mu


class DenoiserState(NamedTuple):
    """Per-channel temporal history (one per stable plane and channel,
    the NRD instance array of Sample.h:174)."""
    radiance: torch.Tensor     # (H,W,3) accumulated demodulated radiance
    moments: torch.Tensor      # (H,W,2) luminance m1, m2
    history: torch.Tensor      # (H,W) frames accumulated
    normal: torch.Tensor       # (H,W,3) previous normals
    view_z: torch.Tensor       # (H,W) previous depth

    @staticmethod
    def create(h: int, w: int, device) -> "DenoiserState":
        z = lambda *s: torch.zeros((h, w) + s, dtype=torch.float32,
                                   device=device)
        return DenoiserState(radiance=z(3), moments=z(2), history=z(),
                             normal=z(3),
                             view_z=torch.full((h, w), 1e30,
                                               dtype=torch.float32,
                                               device=device))


def _bilinear_gather(img, x, y):
    """Bilinear fetch of (H,W,C) at float coordinates, clamped; one row
    gather per corner of the channel-stacked image."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    flat = img.reshape((h * w,) + img.shape[2:])
    a = flat[y0 * w + x0] * (1 - fx) + flat[y0 * w + x1] * fx
    b = flat[y1 * w + x0] * (1 - fx) + flat[y1 * w + x1] * fx
    return a * (1 - fy) + b * fy


def _pad_edge(x, ry: int, rx: int):
    """Edge-clamp pad of the two leading (H, W) axes."""
    h, w = x.shape[0], x.shape[1]
    rows = torch.clamp(torch.arange(-ry, h + ry, device=x.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-rx, w + rx, device=x.device), 0, w - 1)
    return x[rows][:, cols]


def _tap(xp, h: int, w: int, dy: int, dx: int, r: int):
    """(H,W,...) window of an r-padded array shifted by (dy, dx): the
    value of pixel (y, x) is x[clamp(y - dy), clamp(x - dx)]."""
    return xp[r - dy:r - dy + h, r - dx:r - dx + w]


def _shift(x, dy: int, dx: int):
    """(H,W,...) shifted by (dy, dx) with edge clamp: the value of pixel
    (y, x) is x[clamp(y - dy), clamp(x - dx)]."""
    r = max(abs(dy), abs(dx), 1)
    return _tap(_pad_edge(x, r, r), x.shape[0], x.shape[1], dy, dx, r)


def _neighborhood_box(x, radius: int = 1):
    """Per-pixel mean and std of the (2r+1)^2 neighbourhood of (H,W,C)."""
    h, w = x.shape[0], x.shape[1]
    xp = _pad_edge(x, radius, radius)
    n = 0
    m1 = torch.zeros_like(x)
    m2 = torch.zeros_like(x)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            s = _tap(xp, h, w, dy, dx, radius)
            m1 = m1 + s
            m2 = m2 + s * s
            n += 1
    m1 = m1 / n
    return m1, torch.sqrt(torch.clamp(m2 / n - m1 * m1, min=0.0))


def _grid(h: int, w: int, device):
    yy, xx = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return yy, xx


def temporal_accumulate(state: DenoiserState, radiance, normal, view_z,
                        motion, max_history: float = 32.0,
                        history_clamp: float = 3.0) -> DenoiserState:
    """Reproject the history with the motion vectors (prev - cur, px),
    validate the geometry, clamp the history to mean +- k sigma of the
    current 3x3 neighbourhood (NRD's anti-lag clamp) and blend."""
    h, w = radiance.shape[0], radiance.shape[1]
    yy, xx = _grid(h, w, radiance.device)
    px = xx + motion[..., 0]
    py = yy + motion[..., 1]
    in_bounds = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    stacked = torch.cat([state.radiance, state.moments,
                         state.history[..., None], state.normal,
                         state.view_z[..., None]], -1)
    prev = _bilinear_gather(stacked, px, py)
    prev_rad, prev_mom = prev[..., 0:3], prev[..., 3:5]
    prev_hist, prev_nrm, prev_z = prev[..., 5], prev[..., 6:9], prev[..., 9]

    # disocclusion tests (plane distance + normal, NRD-style)
    nrm_ok = torch.sum(normal * prev_nrm, -1) > 0.8
    z_ok = torch.abs(view_z - prev_z) < 0.1 * torch.clamp(view_z, min=1e-3)
    valid = in_bounds & nrm_ok & z_ok & (view_z < 1e29)

    if history_clamp > 0.0:
        box_m, box_s = _neighborhood_box(radiance, 1)
        clamped = torch.clamp(prev_rad, box_m - history_clamp * box_s,
                              box_m + history_clamp * box_s)
        # shorten the history as far as the clamp moved it
        moved = mu.luminance(torch.abs(clamped - prev_rad)) / torch.clamp(
            mu.luminance(box_m) + 1e-4, min=1e-4)
        prev_rad = clamped
        prev_hist = prev_hist * torch.clamp(1.0 - moved, 0.25, 1.0)

    hist = torch.where(valid, torch.clamp(prev_hist + 1.0, max=max_history),
                       1.0)
    alpha = (1.0 / hist)[..., None]
    lum = mu.luminance(radiance)
    mom_new = torch.stack([lum, lum * lum], -1)
    v3 = valid[..., None]
    rad = mu.lerp(torch.where(v3, prev_rad, radiance), radiance, alpha)
    mom = mu.lerp(torch.where(v3, prev_mom, mom_new), mom_new, alpha)
    return DenoiserState(radiance=rad, moments=mom, history=hist,
                         normal=normal, view_z=view_z)


def _box_blur_zero(x, radius: int):
    """Mean over the (2r+1)^2 box with zero padding (convolve2d 'same')."""
    h, w = x.shape
    k = 2 * radius + 1
    xp = torch.nn.functional.pad(x, (radius, radius, radius, radius))
    rows = sum(xp[dy:dy + h] for dy in range(k))
    return sum(rows[:, dx:dx + w] for dx in range(k)) * (1.0 / (k * k))


def estimate_variance(state: DenoiserState):
    m1 = state.moments[..., 0]
    m2 = state.moments[..., 1]
    temporal_var = torch.clamp(m2 - m1 * m1, min=0.0)
    lum = mu.luminance(state.radiance)
    bm1 = _box_blur_zero(lum, 3)
    bm2 = _box_blur_zero(lum * lum, 3)
    spatial_var = torch.clamp(bm2 - bm1 * bm1, min=0.0)
    return torch.where(state.history < 4.0, spatial_var, temporal_var)


def atrous_filter(radiance, variance, normal, view_z, roughness=None,
                  iterations: int = 5, phi_lum: float = 4.0,
                  phi_normal: float = 64.0, phi_z: float = 1.0):
    """Edge-aware a-trous wavelet passes (the SVGF / ReLAX core). With
    `roughness` the channel is specular: the normal edge-stopper sharpens
    as roughness drops and a roughness edge-stopper keeps materials
    apart (ReLAX's specular lobe-similarity weights)."""
    h, w = radiance.shape[0], radiance.shape[1]
    weights_5 = [1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16]
    if roughness is not None:
        phi_n_eff = phi_normal / torch.clamp(roughness * roughness,
                                             1.0 / 64.0, 1.0)
        lum_scale = torch.clamp(roughness * 2.0, 0.1, 1.0)
        guides = torch.cat([normal, view_z[..., None], roughness[..., None]],
                           -1)
    else:
        phi_n_eff = phi_normal
        lum_scale = 1.0
        guides = torch.cat([normal, view_z[..., None]], -1)
    big_r = 2 << max(iterations - 1, 0)
    gp = _pad_edge(guides, big_r, big_r)
    wc = weights_5[2] * weights_5[2]
    for it in range(iterations):
        step = 1 << it
        lum_c = mu.luminance(radiance)
        sigma_l = phi_lum * lum_scale * torch.sqrt(
            torch.clamp(variance, min=1e-10)) + 1e-4
        data = torch.cat([radiance, variance[..., None], lum_c[..., None]],
                         -1)
        dp = _pad_edge(data, 2 * step, 2 * step)
        acc = radiance * wc
        acc_v = variance * wc ** 2
        acc_w = torch.full_like(lum_c, wc)
        for jy in range(-2, 3):
            for jx in range(-2, 3):
                if jy == 0 and jx == 0:
                    continue
                wk = weights_5[jy + 2] * weights_5[jx + 2]
                d_s = _tap(dp, h, w, jy * step, jx * step, 2 * step)
                g_s = _tap(gp, h, w, jy * step, jx * step, big_r)
                w_l = torch.exp(-torch.abs(d_s[..., 4] - lum_c) / sigma_l)
                w_n = torch.clamp(torch.sum(normal * g_s[..., 0:3], -1),
                                  min=0.0) ** phi_n_eff
                w_z = torch.exp(-torch.abs(g_s[..., 3] - view_z)
                                / (phi_z * torch.clamp(view_z, min=1e-3)))
                wgt = wk * w_l * w_n * w_z
                if roughness is not None:
                    wgt = wgt * torch.exp(-torch.abs(g_s[..., 4] - roughness)
                                          / 0.3)
                acc = acc + d_s[..., 0:3] * wgt[..., None]
                acc_v = acc_v + d_s[..., 3] * wgt * wgt
                acc_w = acc_w + wgt
        radiance = acc / torch.clamp(acc_w[..., None], min=1e-8)
        variance = acc_v / torch.clamp(acc_w * acc_w, min=1e-8)
    return radiance


def denoise(state: Optional[DenoiserState], radiance, normal, view_z,
            motion, roughness=None, iterations: int = 4):
    """The pipeline for one channel; returns (filtered, new state)."""
    h, w = radiance.shape[0], radiance.shape[1]
    if state is None:
        state = DenoiserState.create(h, w, radiance.device)
    state = temporal_accumulate(state, radiance, normal, view_z, motion)
    var = estimate_variance(state)
    return atrous_filter(state.radiance, var, normal, view_z, roughness,
                         iterations=iterations), state


# ---- TAA (post/taa.py) ------------------------------------------------

class TAAState(NamedTuple):
    history: torch.Tensor   # (H,W,3)
    valid: bool             # has any history


def _crw(f):
    """Catmull-Rom weights of the offsets -1, 0, 1, 2."""
    f2 = f * f
    f3 = f2 * f
    return (-0.5 * f3 + f2 - 0.5 * f, 1.5 * f3 - 2.5 * f2 + 1.0,
            -1.5 * f3 + 2.0 * f2 + 0.5 * f, 0.5 * f3 - 0.5 * f2)


def _catmull_rom_gather(img, x, y):
    """Exact 16-texel Catmull-Rom resampling of (H,W,3) at float
    coordinates: the 4x4 neighbourhood is stacked channel-wise by 16
    edge-clamped shifts, so the resample is one 48-column row gather at
    the integer base texel and the separable weights."""
    h, w = img.shape[0], img.shape[1]
    xc = torch.floor(x - 0.5) + 0.5
    yc = torch.floor(y - 0.5) + 0.5
    wx = _crw(x - xc)
    wy = _crw(y - yc)
    pimg = _pad_edge(img, 2, 2)
    stacked = torch.cat([_tap(pimg, h, w, -(j - 1), -(i - 1), 2)
                         for j in range(4) for i in range(4)], -1)
    x0 = torch.clamp((xc - 0.5).to(torch.int64), 0, w - 1)
    y0 = torch.clamp((yc - 0.5).to(torch.int64), 0, h - 1)
    rows = stacked.reshape(h * w, 48)[y0 * w + x0].reshape(x.shape + (16, 3))
    acc = 0.0
    wacc = 0.0
    for j in range(4):
        for i in range(4):
            tw = wx[i] * wy[j]
            acc = acc + rows[..., 4 * j + i, :] * tw[..., None]
            wacc = wacc + tw
    return acc / torch.clamp(wacc[..., None], min=1e-8)


def resolve(state: Optional[TAAState], color, motion, blend: float = 0.1,
            clip_sigma: float = 1.0, relax_mask=None):
    """color: (H,W,3) current frame; motion: (H,W,2) px (prev - cur).
    Returns (resolved, new state). relax_mask (H,W) in [0,1]: the
    denoiser's history-reset signal; where it is high the blend snaps to
    the current frame (Sample.cpp:1469-1482)."""
    h, w = color.shape[0], color.shape[1]
    if state is None or not state.valid:
        return color, TAAState(history=color, valid=True)
    yy, xx = _grid(h, w, color.device)
    px = xx + motion[..., 0]
    py = yy + motion[..., 1]
    hist = _catmull_rom_gather(state.history, px, py)
    in_bounds = ((px >= 0) & (px <= w - 1) & (py >= 0)
                 & (py <= h - 1))[..., None]

    # variance clip of the history to the 3x3 window
    m1, m2, cmin, cmax = color, color * color, color, color
    cp = _pad_edge(color, 1, 1)
    for jy in (-1, 0, 1):
        for jx in (-1, 0, 1):
            if jy == 0 and jx == 0:
                continue
            s = _tap(cp, h, w, jy, jx, 1)
            m1 = m1 + s
            m2 = m2 + s * s
            cmin = torch.minimum(cmin, s)
            cmax = torch.maximum(cmax, s)
    m1 = m1 / 9.0
    sigma = torch.sqrt(torch.clamp(m2 / 9.0 - m1 * m1, min=0.0))
    lo = torch.maximum(m1 - clip_sigma * sigma, cmin)
    hi = torch.minimum(m1 + clip_sigma * sigma, cmax)
    hist = torch.clamp(hist, lo, hi)

    blend_eff = torch.full(color.shape[:2], blend, dtype=torch.float32,
                           device=color.device)
    if relax_mask is not None:
        blend_eff = torch.maximum(blend_eff, torch.clamp(relax_mask, 0.0,
                                                         1.0))
    out = torch.where(in_bounds, mu.lerp(hist, color, blend_eff[..., None]),
                      color)
    return out, TAAState(history=out, valid=True)
