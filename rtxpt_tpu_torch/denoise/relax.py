"""ReLAX-style real-time denoiser, the NRD slot (counterpart of
rtxpt_tpu/denoise/relax.py; NrdIntegration.cpp's
RELAX_DIFFUSE_SPECULAR, inputs from PostProcess.hlsl
DenoiserPrepareInputs, driven per stable plane by Sample.cpp:2398-2440).

The published ReLAX structure, as tensor stencils over (H, W) buffers:
  1. temporal reprojection and accumulation of demodulated radiance and
     luminance moments (history length per pixel, geometry-validated,
     anti-lag colour-box clamp);
  2. variance: temporal where the history is long, a 7x7 spatial box for
     young pixels;
  3. N edge-aware a-trous wavelet passes with variance-guided luminance,
     normal and depth edge-stopping (specular: roughness-sharpened).

`temporal_accumulate`, `estimate_variance` and `atrous_filter` decide by
their tensors' device (`cuda_lib.on_cuda`): CUDA tensors launch one kernel
per pass and per a-trous iteration (``csrc/relax.cu``, bit-equal to the
plain version on the card), CPU tensors take the plain version (the
``*_plain`` functions), which the tests hold against the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import mathutils as mu
from ..ops import cuda_lib


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


def temporal_accumulate_plain(state: DenoiserState, radiance, normal,
                              view_z, motion, max_history: float = 32.0,
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


def estimate_variance_plain(state: DenoiserState):
    m1 = state.moments[..., 0]
    m2 = state.moments[..., 1]
    temporal_var = torch.clamp(m2 - m1 * m1, min=0.0)
    lum = mu.luminance(state.radiance)
    bm1 = _box_blur_zero(lum, 3)
    bm2 = _box_blur_zero(lum * lum, 3)
    spatial_var = torch.clamp(bm2 - bm1 * bm1, min=0.0)
    return torch.where(state.history < 4.0, spatial_var, temporal_var)


def atrous_filter_plain(radiance, variance, normal, view_z, roughness=None,
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


@cuda_lib.counted("relax_temporal")
def temporal_accumulate(state: DenoiserState, radiance, normal, view_z,
                        motion, max_history: float = 32.0,
                        history_clamp: float = 3.0) -> DenoiserState:
    """Reproject, validate, clamp and blend the history
    (`temporal_accumulate_plain`); on CUDA tensors one launch that reads
    the history's fields in place."""
    if not cuda_lib.on_cuda(radiance, normal, view_z, motion, *state):
        return temporal_accumulate_plain(state, radiance, normal, view_z,
                                         motion, max_history, history_clamp)
    h, w = radiance.shape[0], radiance.shape[1]
    ins = [cuda_lib.kernel_operand(t, name, (h, w) + c) for t, name, c in (
        (state.radiance, "state.radiance", (3,)),
        (state.moments, "state.moments", (2,)),
        (state.history, "state.history", ()),
        (state.normal, "state.normal", (3,)),
        (state.view_z, "state.view_z", ()),
        (radiance, "radiance", (3,)), (normal, "normal", (3,)),
        (view_z, "view_z", ()), (motion, "motion", (2,)))]
    new = lambda *c: torch.empty((h, w) + c, dtype=torch.float32,
                                 device=radiance.device)
    rad, mom, hist = new(3), new(2), new()
    if h * w:
        cuda_lib.bump("relax_temporal")
        cuda_lib.launch("rtxpt_relax_temporal",
                        *(t.data_ptr() for t in ins), rad.data_ptr(),
                        mom.data_ptr(), hist.data_ptr(), h, w, max_history,
                        history_clamp)
    return DenoiserState(radiance=rad, moments=mom, history=hist,
                         normal=normal, view_z=view_z)


@cuda_lib.counted("relax_variance")
def estimate_variance(state: DenoiserState):
    """Per-pixel luminance variance (`estimate_variance_plain`); on CUDA
    tensors one launch."""
    if not cuda_lib.on_cuda(state.radiance, state.moments, state.history):
        return estimate_variance_plain(state)
    h, w = state.history.shape[0], state.history.shape[1]
    rad = cuda_lib.kernel_operand(state.radiance, "state.radiance", (h, w, 3))
    mom = cuda_lib.kernel_operand(state.moments, "state.moments", (h, w, 2))
    hist = cuda_lib.kernel_operand(state.history, "state.history", (h, w))
    out = torch.empty((h, w), dtype=torch.float32, device=hist.device)
    if h * w:
        cuda_lib.bump("relax_variance")
        cuda_lib.launch("rtxpt_relax_variance", rad.data_ptr(),
                        mom.data_ptr(), hist.data_ptr(), out.data_ptr(), h, w)
    return out


@cuda_lib.counted("relax_atrous")
def atrous_filter(radiance, variance, normal, view_z, roughness=None,
                  iterations: int = 5, phi_lum: float = 4.0,
                  phi_normal: float = 64.0, phi_z: float = 1.0):
    """The a-trous passes (`atrous_filter_plain`); on CUDA tensors one
    launch per iteration (step 1, 2, 4, ...), ping-ponging between two
    pairs of buffers."""
    guides = (normal, view_z) if roughness is None else (normal, view_z,
                                                         roughness)
    if not cuda_lib.on_cuda(radiance, variance, *guides):
        return atrous_filter_plain(radiance, variance, normal, view_z,
                                   roughness, iterations, phi_lum,
                                   phi_normal, phi_z)
    h, w = radiance.shape[0], radiance.shape[1]
    rad = cuda_lib.kernel_operand(radiance, "radiance", (h, w, 3))
    var = cuda_lib.kernel_operand(variance, "variance", (h, w))
    nrm = cuda_lib.kernel_operand(normal, "normal", (h, w, 3))
    z = cuda_lib.kernel_operand(view_z, "view_z", (h, w))
    rough = None if roughness is None else cuda_lib.kernel_operand(
        roughness, "roughness", (h, w))
    bufs = [(torch.empty_like(rad), torch.empty_like(var))
            for _ in range(min(iterations, 2))]
    for it in range(iterations):
        o_rad, o_var = bufs[it % 2]
        if h * w:
            cuda_lib.bump("relax_atrous")
            cuda_lib.launch("rtxpt_relax_atrous", rad.data_ptr(),
                            var.data_ptr(), nrm.data_ptr(), z.data_ptr(),
                            None if rough is None else rough.data_ptr(),
                            o_rad.data_ptr(), o_var.data_ptr(), h, w,
                            1 << it, phi_lum, phi_normal, phi_z)
        rad, var = o_rad, o_var
    return rad


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
