"""Temporal anti-aliasing (counterpart of rtxpt_tpu/post/taa.py; donut's
TemporalAntiAliasingPass, taa_cs.hlsl, wired at Sample.cpp:1469-1482):
Catmull-Rom history resampling, variance clipping of the history to
mean +- k sigma of the 3x3 window, exponential blend. The R2 jitter
sequence is models/renderer.r2_jitter.

`resolve` decides by its tensors' device (`cuda_lib.on_cuda`): with a
valid history, CUDA tensors launch one kernel (``csrc/relax.cu``,
bit-equal to the plain version on the card), CPU tensors take the plain
version, `resolve_plain`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import mathutils as mu
from ..denoise.relax import _grid, _pad_edge, _tap
from ..ops import cuda_lib


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


def resolve_plain(state: Optional[TAAState], color, motion,
                  blend: float = 0.1, clip_sigma: float = 1.0,
                  relax_mask=None):
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


@cuda_lib.counted("taa_resolve")
def resolve(state: Optional[TAAState], color, motion, blend: float = 0.1,
            clip_sigma: float = 1.0, relax_mask=None):
    """`resolve_plain`; with a valid history on CUDA tensors one launch,
    the Catmull-Rom texels and the 3x3 window read by clamped index."""
    masks = () if relax_mask is None else (relax_mask,)
    if state is None or not state.valid or not cuda_lib.on_cuda(
            state.history, color, motion, *masks):
        return resolve_plain(state, color, motion, blend, clip_sigma,
                             relax_mask)
    h, w = color.shape[0], color.shape[1]
    hist = cuda_lib.kernel_operand(state.history, "state.history", (h, w, 3))
    col = cuda_lib.kernel_operand(color, "color", (h, w, 3))
    mot = cuda_lib.kernel_operand(motion, "motion", (h, w, 2))
    mask = None if relax_mask is None else cuda_lib.kernel_operand(
        relax_mask, "relax_mask", (h, w))
    out = torch.empty_like(col)
    if h * w:
        cuda_lib.bump("taa_resolve")
        cuda_lib.launch("rtxpt_taa_resolve", hist.data_ptr(), col.data_ptr(),
                        mot.data_ptr(),
                        None if mask is None else mask.data_ptr(),
                        out.data_ptr(), h, w, blend, clip_sigma)
    return out, TAAState(history=out, valid=True)
