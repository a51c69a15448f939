"""Tone mapping: exposure, white balance, eye adaptation and the
operators, with histogram auto-exposure (counterpart of
rtxpt_tpu/post/tonemap.py; ToneMappingPasses.cpp luminance histogram
:364-460, operators ToneMappingPasses.h:39-55)."""
from __future__ import annotations

import numpy as np
import torch

from ..core import mathutils as mu

OP_LINEAR = 0
OP_REINHARD = 1
OP_ACES = 2
OP_HABLE_UC2 = 3      # Uncharted 2 filmic (donut HableUc2)
OP_CLAMP = 4          # plain clamp (the reference's 'Clamp' operator)

_HISTOGRAM_BINS = 128
_LOG_LUM_MIN = -10.0
_LOG_LUM_MAX = 8.0


def luminance_histogram(rgb):
    """(H,W,3) -> (BINS,) luminance histogram over log2 luminance."""
    lum = mu.luminance(torch.clamp(rgb, min=0.0))
    loglum = torch.log2(torch.clamp(lum, min=1e-10))
    t = (loglum - _LOG_LUM_MIN) / (_LOG_LUM_MAX - _LOG_LUM_MIN)
    bins = torch.clamp((t * _HISTOGRAM_BINS).to(torch.int64), 0,
                       _HISTOGRAM_BINS - 1)
    return torch.bincount(bins.reshape(-1), minlength=_HISTOGRAM_BINS)


def auto_exposure(rgb, low_percentile=0.6, high_percentile=0.95,
                  key_value=0.18, min_ev=-12.0, max_ev=12.0):
    """Average log-luminance between two histogram percentiles, returned
    as a linear exposure scale (0-d tensor)."""
    hist = luminance_histogram(rgb).to(torch.float32)
    cdf = torch.cumsum(hist, dim=0)
    total = torch.clamp(cdf[-1], min=1.0)
    lo = low_percentile * total
    hi = high_percentile * total
    inside = torch.minimum(torch.maximum(cdf, lo), hi) - torch.minimum(
        torch.maximum(cdf - hist, lo), hi)
    centers = _LOG_LUM_MIN + (torch.arange(
        _HISTOGRAM_BINS, dtype=torch.float32, device=rgb.device) + 0.5) \
        / _HISTOGRAM_BINS * (_LOG_LUM_MAX - _LOG_LUM_MIN)
    avg_log = torch.sum(inside * centers) / torch.clamp(torch.sum(inside),
                                                        min=1e-5)
    avg_log = torch.clamp(avg_log, min_ev, max_ev)
    return key_value / torch.exp2(avg_log)


def aces_fitted(x):
    """ACES filmic fit (Narkowicz), donut's ACES operator."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def reinhard(x):
    return x / (1.0 + x)


def hable_uc2(x, white_point: float = 11.2):
    """Uncharted 2 filmic operator (ToneMappingPasses.h HableUc2)."""
    def f(v):
        a, b, c, d, e, f_ = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        return ((v * (a * v + c * b) + d * e)
                / (v * (a * v + b) + d * f_)) - e / f_
    white = torch.tensor(white_point, dtype=torch.float32, device=x.device)
    return torch.clamp(f(x) / f(white), 0.0, 1.0)


def white_balance_scale(temperature_k: float = 6500.0, device="cpu"):
    """(3,) linear-sRGB multipliers that neutralize an illuminant of
    `temperature_k` (6500 K is the identity): the Kim et al. fit of the
    Planckian locus, xyY -> XYZ -> linear sRGB, normalized to mean 1."""
    t = float(np.clip(temperature_k, 1667.0, 25000.0)) / 1000.0
    if t < 4.0:
        x = (-0.2661239 / t ** 3 - 0.2343589 / t ** 2
             + 0.8776956 / t + 0.179910)
    else:
        x = (-3.0258469 / t ** 3 + 2.1070379 / t ** 2
             + 0.2226347 / t + 0.240390)
    y = -3.0 * x * x + 2.87 * x - 0.275
    xyz = np.asarray([x / y, 1.0, (1 - x - y) / y], np.float64)
    m = np.asarray([[3.2404542, -1.5371385, -0.4985314],
                    [-0.9692660, 1.8760108, 0.0415560],
                    [0.0556434, -0.2040259, 1.0572252]])
    rgb = np.maximum(m @ xyz, 1e-4)
    scale = 1.0 / rgb
    scale /= scale.mean()
    return torch.as_tensor(scale.astype(np.float32), device=device)


def linear_to_srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * torch.pow(torch.clamp(x, min=1e-7),
                                         1.0 / 2.4) - 0.055)


def tonemap(rgb, exposure: float = 1.0, operator: int = OP_ACES,
            auto_expose: bool = False, white_balance_k: float = 6500.0,
            prev_exposure=None, adaptation_rate: float = 0.0):
    """HDR (H,W,3) -> display sRGB (H,W,3) in [0,1].

    `white_balance_k`: the illuminant's temperature (6500 is neutral).
    `prev_exposure` with `adaptation_rate` > 0 adapts the exposure toward
    this frame's exponentially (eye adaptation, ToneMappingPasses::
    AdvanceFrame). With `prev_exposure` given, returns (srgb, exposure)."""
    scale = torch.tensor(exposure, dtype=torch.float32, device=rgb.device)
    if auto_expose:
        scale = scale * auto_exposure(rgb)
    if prev_exposure is not None and adaptation_rate > 0.0:
        scale = prev_exposure + (scale - prev_exposure) * adaptation_rate
    x = torch.clamp(rgb, min=0.0) * scale
    if white_balance_k != 6500.0:
        x = x * white_balance_scale(white_balance_k, rgb.device)
    if operator == OP_ACES:
        y = aces_fitted(x)
    elif operator == OP_REINHARD:
        y = reinhard(x)
    elif operator == OP_HABLE_UC2:
        y = hable_uc2(x)
    elif operator == OP_CLAMP:
        y = torch.clamp(x, 0.0, 1.0)
    else:
        y = x
    out = linear_to_srgb(y)
    if prev_exposure is not None:
        return out, scale
    return out
