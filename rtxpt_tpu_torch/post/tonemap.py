"""Tone mapping with histogram auto-exposure (counterpart of
rtxpt_tpu/post/tonemap.py; ToneMappingPasses.cpp luminance histogram
:364-460, ACES operator ToneMappingPasses.h:39-55). The reference's other
operators, white balance and eye adaptation serve its realtime viewer and
are not carried."""
from __future__ import annotations

import torch

from ..core import mathutils as mu

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


def linear_to_srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * torch.pow(torch.clamp(x, min=1e-7),
                                         1.0 / 2.4) - 0.055)


def tonemap(rgb, exposure: float = 1.0, auto_expose: bool = False):
    """HDR (H,W,3) -> display sRGB (H,W,3) in [0,1] through ACES."""
    scale = torch.tensor(exposure, dtype=torch.float32, device=rgb.device)
    if auto_expose:
        scale = scale * auto_exposure(rgb)
    return linear_to_srgb(aces_fitted(torch.clamp(rgb, min=0.0) * scale))
