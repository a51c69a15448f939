"""Offline photo-mode denoiser, the OptiX/OIDN slot (counterpart of
rtxpt_tpu/denoise/offline.py; DenoisedScreenshot, Sample.cpp:2572-2600,
which runs tools/denoiser_OptiX/Denoiser.exe on the screenshot).

An a-trous cross-bilateral filter guided by the first-hit albedo, normal
and depth (the guides OIDN reads), tuned for converged input: the image
is demodulated by the albedo so texture detail is kept, the illumination
is filtered and then remodulated.
"""
from __future__ import annotations

import torch

from ..core import mathutils as mu
from .relax import _shift


def photo_denoise(hdr, albedo, normal, view_z, iterations: int = 3,
                  sigma_lum: float = 0.35, phi_normal: float = 96.0,
                  phi_albedo: float = 8.0, phi_z: float = 0.6):
    """hdr, albedo, normal: (H,W,3); view_z: (H,W). Returns the filtered
    HDR image."""
    eps = 1e-3
    out = hdr / torch.clamp(albedo, min=eps)
    weights_5 = [1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16]
    wc = weights_5[2] ** 2
    for it in range(iterations):
        step = 1 << it
        lum_c = mu.luminance(out)
        acc = out * wc
        acc_w = torch.full_like(lum_c, wc)
        for jy in range(-2, 3):
            for jx in range(-2, 3):
                if jy == 0 and jx == 0:
                    continue
                wk = weights_5[jy + 2] * weights_5[jx + 2]
                s = _shift(out, jy * step, jx * step)
                nrm_s = _shift(normal, jy * step, jx * step)
                alb_s = _shift(albedo, jy * step, jx * step)
                z_s = _shift(view_z, jy * step, jx * step)
                w_l = torch.exp(-torch.abs(mu.luminance(s) - lum_c)
                                / (sigma_lum * (1.0 + lum_c) + 1e-4))
                w_n = torch.clamp(torch.sum(normal * nrm_s, -1),
                                  min=0.0) ** phi_normal
                w_a = torch.exp(-phi_albedo * torch.sum(
                    torch.abs(alb_s - albedo), -1))
                w_z = torch.exp(-torch.abs(z_s - view_z)
                                / (phi_z * torch.clamp(view_z, min=1e-3)))
                w = wk * w_l * w_n * w_a * w_z
                acc = acc + s * w[..., None]
                acc_w = acc_w + w
        out = acc / torch.clamp(acc_w[..., None], min=1e-8)
    return out * torch.clamp(albedo, min=eps)


def photo_denoise_auto(renderer, hdr, width: int, height: int):
    """Trace the guide G-buffer with the renderer's camera and filter
    `hdr` (the CLI's --photo-denoise)."""
    from ..pt import gbuffer as GB
    px, py = renderer._pixel_grid(width, height)
    gb = GB.trace_gbuffer(renderer.assets, renderer.camera, renderer.camera,
                          px, py)
    shp = (height, width)
    albedo = torch.clamp((gb.diffuse_albedo + gb.specular_albedo).reshape(
        shp + (3,)), 0.0, 1.0)
    return photo_denoise(hdr, albedo, gb.normal.reshape(shp + (3,)),
                         gb.view_z.reshape(shp))
