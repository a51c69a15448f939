"""ReBLUR-style real-time denoiser, the NRD slot's second denoiser
(counterpart of rtxpt_tpu/denoise/reblur.py; REBLUR_DIFFUSE_SPECULAR,
selected at Sample.cpp:1461-1466, its stages dispatched at
NrdIntegration.cpp:506).

The published ReBLUR structure, as tensor stencils over (H, W) buffers:
  1. temporal accumulation with geometry-validated reprojection and an
     accumulated hit-distance channel beside the radiance; a fast
     (at most 4-frame) history clamps the long one (anti-lag);
  2. an anti-firefly cross-neighbourhood luminance clamp;
  3. rotated Poisson-disk bilateral passes whose per-pixel radius grows
     with the accumulated hit distance, shrinks with the history length
     and, for specular, with roughness;
  4. history fix: pixels with a short history take one wide pass;
  5. temporal stabilization of the output against its own reprojected
     history, clamped to the 3x3 box.

Same (filtered, state) contract as relax.denoise, so the realtime post
stages switch on PTConfig.denoiser_method.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core import mathutils as mu
from .relax import _bilinear_gather, _grid, _neighborhood_box, _shift

MAX_HISTORY = 32.0
BASE_RADIUS_PX = 16.0
MAX_FAST_HISTORY = 4.0
HISTORY_FIX_FRAMES = 4.0     # ReBLUR historyFixFrameNum default

# 8-point Poisson disk (unit radius), rotated per pass
_POISSON = [
    (-0.4706069, -0.4427112), (-0.9057375, 0.3003471),
    (-0.3487388, 0.4037880), (0.1023042, 0.6439373),
    (0.5699277, 0.3513750), (0.2939128, -0.1131226),
    (0.7836658, -0.4208784), (0.1564120, -0.8198990),
]


class ReblurState(NamedTuple):
    """Per-channel temporal history (one per stable plane and channel)."""
    radiance: torch.Tensor   # (H,W,3) accumulated demodulated radiance
    fast: torch.Tensor       # (H,W,3) fast (<= 4-frame) history
    hit_t: torch.Tensor      # (H,W) accumulated hit distance
    history: torch.Tensor    # (H,W) frames accumulated
    normal: torch.Tensor     # (H,W,3)
    view_z: torch.Tensor     # (H,W)
    stab: torch.Tensor       # (H,W,3) temporal-stabilization history
    stab_valid: bool         # the stabilization history holds a frame

    @staticmethod
    def create(h: int, w: int, device) -> "ReblurState":
        z = lambda *s: torch.zeros((h, w) + s, dtype=torch.float32,
                                   device=device)
        return ReblurState(radiance=z(3), fast=z(3), hit_t=z(), history=z(),
                           normal=z(3),
                           view_z=torch.full((h, w), 1e30,
                                             dtype=torch.float32,
                                             device=device),
                           stab=z(3), stab_valid=False)


def _accumulate(state: ReblurState, radiance, hit_t, normal, view_z, motion,
                history_clamp: float = 3.0) -> ReblurState:
    h, w = radiance.shape[0], radiance.shape[1]
    yy, xx = _grid(h, w, radiance.device)
    px = xx + motion[..., 0]
    py = yy + motion[..., 1]
    in_bounds = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    # one reprojection gather of every history channel
    stacked = torch.cat([state.radiance, state.hit_t[..., None],
                         state.history[..., None], state.normal,
                         state.view_z[..., None], state.fast, state.stab],
                        -1)
    prev = _bilinear_gather(stacked, px, py)
    prev_rad, prev_hit, prev_hist = prev[..., 0:3], prev[..., 3], \
        prev[..., 4]
    prev_nrm, prev_z = prev[..., 5:8], prev[..., 8]
    prev_fast, prev_stab = prev[..., 9:12], prev[..., 12:15]
    nrm_ok = torch.sum(normal * prev_nrm, -1) > 0.8
    z_ok = torch.abs(view_z - prev_z) < 0.1 * torch.clamp(view_z, min=1e-3)
    valid = in_bounds & nrm_ok & z_ok & (view_z < 1e29)

    if history_clamp > 0.0:
        box_m, box_s = _neighborhood_box(radiance, 1)
        clamped = torch.clamp(prev_rad, box_m - history_clamp * box_s,
                              box_m + history_clamp * box_s)
        moved = mu.luminance(torch.abs(clamped - prev_rad)) / torch.clamp(
            mu.luminance(box_m) + 1e-4, min=1e-4)
        prev_rad = clamped
        prev_hist = prev_hist * torch.clamp(1.0 - moved, 0.25, 1.0)

    hist = torch.where(valid, torch.clamp(prev_hist + 1.0, max=MAX_HISTORY),
                       1.0)
    alpha = 1.0 / hist
    v3 = valid[..., None]
    rad = mu.lerp(torch.where(v3, prev_rad, radiance), radiance,
                  alpha[..., None])
    ht = mu.lerp(torch.where(valid, prev_hit, hit_t), hit_t, alpha)

    # fast history (anti-lag): the long history is clamped to a luminance
    # band around a <= 4-frame accumulation, and where the clamp engaged
    # its length is cut so convergence restarts
    fast_alpha = 1.0 / torch.clamp(hist, max=MAX_FAST_HISTORY)
    fast = mu.lerp(torch.where(v3, prev_fast, radiance), radiance,
                   fast_alpha[..., None])
    lum_slow = mu.luminance(rad)
    lum_fast = mu.luminance(fast)
    band = 0.5 * lum_fast + 1e-3
    lum_clamped = torch.minimum(torch.maximum(lum_slow, lum_fast - band),
                                lum_fast + band)
    scale = lum_clamped / torch.clamp(lum_slow, min=1e-6)
    engaged = torch.abs(scale - 1.0) > 1e-3
    rad = rad * scale[..., None]
    hist = torch.where(engaged, torch.clamp(hist, max=MAX_FAST_HISTORY),
                       hist)
    return ReblurState(radiance=rad, fast=fast, hit_t=ht, history=hist,
                       normal=normal, view_z=view_z, stab=prev_stab,
                       stab_valid=state.stab_valid)


def _blur_pass(radiance, radius_px, normal, view_z, roughness, angle: float):
    """One rotated Poisson-disk bilateral pass with a per-pixel radius."""
    h, w = radiance.shape[0], radiance.shape[1]
    yy, xx = _grid(h, w, radiance.device)
    ca, sa = math.cos(angle), math.sin(angle)
    if roughness is not None:
        phi_n = 32.0 / torch.clamp(roughness * roughness, 1.0 / 32.0, 1.0)
    else:
        phi_n = 8.0
    acc = radiance
    acc_w = torch.ones((h, w), dtype=torch.float32, device=radiance.device)
    stacked = torch.cat([radiance, normal, view_z[..., None]], -1)
    for ox, oy in _POISSON:
        rx, ry = ox * ca - oy * sa, ox * sa + oy * ca
        s = _bilinear_gather(stacked, xx + radius_px * rx,
                             yy + radius_px * ry)
        rad_s, nrm_s, z_s = s[..., 0:3], s[..., 3:6], s[..., 6]
        w_n = torch.clamp(torch.sum(normal * nrm_s, -1), min=0.0) ** phi_n
        w_z = torch.exp(-torch.abs(z_s - view_z)
                        / torch.clamp(0.05 * view_z + 1e-3, min=1e-3))
        wgt = w_n * w_z
        acc = acc + rad_s * wgt[..., None]
        acc_w = acc_w + wgt
    return acc / torch.clamp(acc_w[..., None], min=1e-8)


def _anti_firefly(radiance):
    """Cross-neighbourhood luminance clamp (NRD's REBLUR anti-firefly): a
    pixel brighter than each of its four cross neighbours is scaled down
    to their maximum."""
    lums = [mu.luminance(_shift(radiance, dy, dx))
            for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0))]
    nb_max = torch.maximum(torch.maximum(lums[0], lums[1]),
                           torch.maximum(lums[2], lums[3]))
    scale = torch.clamp(nb_max / torch.clamp(mu.luminance(radiance),
                                             min=1e-6), max=1.0)
    return radiance * scale[..., None]


def denoise(state: Optional[ReblurState], radiance, normal, view_z, motion,
            roughness=None, hit_t=None, iterations: int = 2):
    """The pipeline for one channel: accumulation (with the fast-history
    anti-lag), anti-firefly, the adaptive blur passes, history fix and
    temporal stabilization. hit_t: (H,W) hit distance of the channel (a
    stable plane's committed channel .w); None gives a radius independent
    of distance. Returns (filtered, new state)."""
    h, w = radiance.shape[0], radiance.shape[1]
    dev = radiance.device
    if state is None:
        state = ReblurState.create(h, w, dev)
    if hit_t is None:
        hit_t = torch.full((h, w), 1e4, dtype=torch.float32, device=dev)
    state = _accumulate(state, radiance, hit_t, normal, view_z, motion)

    # anti-firefly before any pass spreads an outlier over its footprint
    signal = _anti_firefly(state.radiance)

    # the radius: the full base radius for far lighting, tight for
    # contact lighting; a converged history and a smooth specular lobe
    # shrink it
    hit_frac = state.hit_t / (state.hit_t
                              + torch.clamp(state.view_z, min=1e-3))
    radius = BASE_RADIUS_PX * hit_frac / torch.sqrt(state.history)
    if roughness is not None:
        radius = radius * torch.clamp(roughness * 2.0, 0.05, 1.0)
    filtered = signal
    for it in range(max(iterations, 1)):
        filtered = _blur_pass(filtered, radius * (0.5 ** it), normal, view_z,
                              roughness, angle=2.399963 * (it + 1))

    # history fix: a short history takes one wide pass, wider the shorter
    # the history
    fix_w = mu.saturate(1.0 - (state.history - 1.0)
                        / (HISTORY_FIX_FRAMES - 1.0))
    wide = _blur_pass(filtered, BASE_RADIUS_PX * (1.0 + fix_w), normal,
                      view_z, roughness, angle=0.5)
    filtered = mu.lerp(filtered, wide, fix_w[..., None])

    # temporal stabilization against the reprojected output history,
    # clamped to the 3x3 box so it never lags
    box_m, box_s = _neighborhood_box(filtered, 1)
    stab_prev = torch.clamp(state.stab, box_m - 2.0 * box_s,
                            box_m + 2.0 * box_s)
    out = mu.lerp(stab_prev, filtered, 0.2 if state.stab_valid else 1.0)
    return out, state._replace(stab=out, stab_valid=True)
