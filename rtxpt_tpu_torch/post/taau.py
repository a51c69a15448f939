"""Temporal anti-aliased upscaling, the DLSS slot (counterpart of
rtxpt_tpu/post/taau.py; render size != display size, Sample.cpp:1733-1781,
the Streamline slot of SLWrapper.cpp).

The path tracer renders at a reduced size and this upsampler produces
the display size:
  * each display pixel fetches the current frame at its exact source
    position in render space with the camera jitter undone, so over
    frames the R2 jitter sequence scans sub-pixel positions;
  * a confidence weight favours display pixels that land close to a
    sample rendered this frame (fresh detail), the others lean on the
    history;
  * the history is kept at display size, reprojected with the upscaled
    motion and variance-clipped against the upsampled frame.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import mathutils as mu
from ..denoise.relax import _bilinear_gather, _grid, _shift


class TAAUState(NamedTuple):
    history: torch.Tensor   # (Hd,Wd,3) display-size history
    valid: bool             # has any history


def resolve(state: Optional[TAAUState], color, motion, display_size,
            jitter=(0.0, 0.0), base_blend: float = 0.01,
            clip_sigma: float = 1.5):
    """color: (Hr,Wr,3) render-size frame; motion: (Hr,Wr,2) in render
    pixels (prev - cur); display_size: (Wd, Hd); jitter: the camera's
    sub-pixel jitter this frame, in render pixels (two floats). Returns
    (display frame (Hd,Wd,3), new state)."""
    hr, wr = color.shape[0], color.shape[1]
    wd, hd = int(display_size[0]), int(display_size[1])
    sx = wr / wd
    sy = hr / hd
    yy, xx = _grid(hd, wd, color.device)
    # display pixel centre -> render-space coordinates, jitter undone
    rx = (xx + 0.5) * sx - 0.5 - float(jitter[0])
    ry = (yy + 0.5) * sy - 0.5 - float(jitter[1])
    cur = _bilinear_gather(color, rx, ry)

    # confidence: distance to the nearest sample rendered this frame
    dx = rx - torch.round(rx)
    dy = ry - torch.round(ry)
    confidence = torch.exp(-(dx * dx + dy * dy) / 0.05)

    if state is None or not state.valid:
        return cur, TAAUState(history=cur, valid=True)

    # motion upsampled to display pixels
    mot = _bilinear_gather(motion, rx, ry) * torch.tensor(
        [1.0 / sx, 1.0 / sy], dtype=torch.float32, device=color.device)
    px = xx + mot[..., 0]
    py = yy + mot[..., 1]
    hist = _bilinear_gather(state.history, px, py)
    in_bounds = ((px >= 0) & (px <= wd - 1) & (py >= 0)
                 & (py <= hd - 1))[..., None]

    # variance clip against the upsampled current frame
    m1 = cur
    m2 = cur * cur
    for jy in (-1, 0, 1):
        for jx in (-1, 0, 1):
            if jy == 0 and jx == 0:
                continue
            s = _shift(cur, jy, jx)
            m1 = m1 + s
            m2 = m2 + s * s
    m1 = m1 / 9.0
    sigma = torch.sqrt(torch.clamp(m2 / 9.0 - m1 * m1, min=0.0))
    # the clip widens where a fresh sample lands (the upsampled frame is
    # band-limited, so a tight clip would erase sub-render-pixel detail)
    # and stays hard elsewhere, against ghosting
    widen = (1.0 + 6.0 * confidence)[..., None]
    hist = torch.minimum(torch.maximum(hist, m1 - clip_sigma * widen * sigma),
                         m1 + clip_sigma * widen * sigma)

    blend = base_blend + (0.5 - base_blend) * confidence[..., None]
    out = torch.where(in_bounds, mu.lerp(hist, cur, blend), cur)
    return out, TAAUState(history=out, valid=True)
