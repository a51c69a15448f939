"""Environment light: baked radiance map + importance sampling
(counterpart of rtxpt_tpu/scene/envmap.py; Distant.hlsli EnvMap::Eval and
EnvMapSampler, EnvMapImportanceSamplingBaker).

Equirectangular (H, 2H, 3) radiance. The host build (numpy) derives the
two row tables the device path reads, both through the row gather of
`ops/gather.py`:
  * radiance_quad (H*W, 12): [self, right, down, diag] RGB per texel, so a
    bilinear eval is one row fetch + lerp;
  * alias_pack (H*W, 10): Vose alias rows [prob, alias, pdf_self,
    pdf_alias, le_self(3), le_alias(3)] over the luminance x solid-angle
    texel pmf of the MIP-descent sampler, so a distant-light draw is one
    row fetch and `pdf_mip_descent` reads pdf_self of the same rows.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import mathutils as mu
from ..ops import gather


@dataclasses.dataclass
class EnvMap:
    radiance_quad: torch.Tensor   # (H*W, 12) f32
    alias_pack: torch.Tensor      # (H*W, 10) f32
    height: int
    width: int
    intensity: float = 1.0
    enabled: bool = True


def dir_to_uv(d):
    """y-up equirect: u from azimuth, v from polar angle."""
    phi = torch.atan2(d[..., 2], d[..., 0])
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    u = (phi + mu.M_PI) / mu.M_2PI
    v = theta / mu.M_PI
    return torch.stack([u, v], dim=-1)


def uv_to_dir(uv):
    phi = uv[..., 0] * mu.M_2PI - mu.M_PI
    theta = uv[..., 1] * mu.M_PI
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), torch.cos(theta),
                        st * torch.sin(phi)], dim=-1)


def _row_solid_angles(h: int, w: int) -> np.ndarray:
    """Exact per-texel solid angle for each row: (2pi/W)(cos t0 - cos t1)."""
    theta = np.linspace(0.0, math.pi, h + 1)
    return ((2.0 * math.pi / w)
            * (np.cos(theta[:-1]) - np.cos(theta[1:]))).astype(np.float32)


def _build_alias_pack(pmf: np.ndarray, pdf_flat: np.ndarray,
                      rad_flat: np.ndarray) -> np.ndarray:
    """Vose's alias method over the texel pmf; rows carry everything a
    draw needs so sampling is one gather."""
    nt = pmf.shape[0]
    p = pmf / max(pmf.sum(), 1e-20) * nt
    alias = np.arange(nt, dtype=np.int64)
    prob = np.ones(nt, np.float64)
    small = [i for i in range(nt) if p[i] < 1.0]
    large = [i for i in range(nt) if p[i] >= 1.0]
    p = p.astype(np.float64).copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    pack = np.zeros((nt, 10), np.float32)
    pack[:, 0] = prob
    pack[:, 1] = alias
    pack[:, 2] = pdf_flat
    pack[:, 3] = pdf_flat[alias]
    pack[:, 4:7] = rad_flat
    pack[:, 7:10] = rad_flat[alias]
    return pack


def build_tables(radiance: np.ndarray):
    """(radiance_quad, alias_pack) of an (H, 2H, 3) radiance map: the
    reference's `_make_envmap_np` restricted to what the device reads."""
    radiance = np.asarray(radiance, np.float32)
    h, w = radiance.shape[0], radiance.shape[1]
    if w != 2 * h or h & (h - 1):
        raise ValueError(f"equirect must be (H, 2H) with H a power of two, "
                         f"got {radiance.shape}")
    omega = _row_solid_angles(h, w)
    lum = (0.2126 * radiance[..., 0] + 0.7152 * radiance[..., 1]
           + 0.0722 * radiance[..., 2])
    base = lum * omega[:, None]       # finest level of the MIP pyramid
    total = max(float(base.sum()), 1e-20)
    pdf_flat = (base / (total * np.maximum(omega[:, None], 1e-20))
                ).reshape(-1).astype(np.float32)
    r_right = np.roll(radiance, -1, axis=1)
    r_down = np.concatenate([radiance[1:], radiance[-1:]], axis=0)
    r_diag = np.roll(r_down, -1, axis=1)
    radiance_quad = np.concatenate(
        [radiance, r_right, r_down, r_diag], axis=-1).reshape(-1, 12)
    alias = _build_alias_pack(base.reshape(-1).astype(np.float64),
                              pdf_flat, radiance.reshape(-1, 3))
    return radiance_quad.astype(np.float32), alias


def make_envmap(radiance, intensity: float = 1.0, enabled: bool = True,
                device="cpu") -> EnvMap:
    radiance = np.asarray(radiance, np.float32)
    quad, alias = build_tables(radiance)
    return EnvMap(radiance_quad=torch.as_tensor(quad, device=device),
                  alias_pack=torch.as_tensor(alias, device=device),
                  height=radiance.shape[0], width=radiance.shape[1],
                  intensity=float(intensity), enabled=bool(enabled))


def eval_dir(env: EnvMap, d):
    """EnvMap::Eval (Distant.hlsli:22-60): bilinearly filtered radiance
    along direction d — one quad-row gather + lerp."""
    uv = dir_to_uv(d)
    h, w = env.height, env.width
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    xi = torch.remainder(x0.to(torch.int32), w)
    yi = torch.clamp(y0.to(torch.int32), 0, h - 1)
    q = gather.gather_rows(env.radiance_quad, yi * w + xi)   # (N,12)
    top = q[..., 0:3] * (1 - tx) + q[..., 3:6] * tx
    bot = q[..., 6:9] * (1 - tx) + q[..., 9:12] * tx
    out = (top * (1 - ty) + bot * ty) * env.intensity
    return out if env.enabled else torch.zeros_like(out)


def sample_importance(env: EnvMap, u2):
    """O(1) importance draw through the alias rows: the same texel pmf
    and pdf values as the MIP-descent sampler (the path the reference
    takes for NEE_DISTANT_MIP_DESCENT when alias rows exist). The
    residuals of the bin pick and the alias coin re-jitter the sample
    inside the chosen texel. Returns (direction, pdf, radiance)."""
    h, w = env.height, env.width
    nt = env.alias_pack.shape[0]
    x = u2[..., 0] * nt
    bin_ = torch.clamp(x.to(torch.int32), max=nt - 1)
    jx = x - bin_.to(torch.float32)
    row = gather.gather_rows(env.alias_pack, bin_)            # (N,10)
    prob = row[..., 0]
    v = u2[..., 1]
    keep = v < prob
    jy = torch.where(keep, v / torch.clamp(prob, min=1e-9),
                     (v - prob) / torch.clamp(1.0 - prob, min=1e-9))
    texel = torch.where(keep, bin_, row[..., 1].to(torch.int32))
    pdf = torch.where(keep, row[..., 2], row[..., 3])
    le = torch.where(keep[..., None], row[..., 4:7], row[..., 7:10]) \
        * env.intensity
    ix = texel % w
    iy = texel // w
    uv = torch.stack([(ix.to(torch.float32)
                       + torch.clamp(jx, 0.0, 0.9999)) / w,
                      (iy.to(torch.float32)
                       + torch.clamp(jy, 0.0, 0.9999)) / h], dim=-1)
    d = uv_to_dir(uv)
    if not env.enabled:
        le = torch.zeros_like(le)
    return d, pdf, le


def pdf_mip_descent(env: EnvMap, d):
    """EnvMapSampler::MIPDescentEvalPdf (Distant.hlsli:180-210): the
    solid-angle pdf of the texel d falls in (pdf_self of its alias row)."""
    uv = dir_to_uv(d)
    h, w = env.height, env.width
    x = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
    return gather.gather_rows(env.alias_pack, y * w + x)[..., 2]


def bake_procedural_sky(height: int = 128,
                        sun_dir=(0.35, 0.65, 0.2),
                        sun_radiance=(600.0, 560.0, 480.0),
                        sun_angular_radius: float = 0.028,
                        zenith=(0.25, 0.45, 0.85),
                        horizon=(0.65, 0.75, 0.9),
                        ground=(0.22, 0.2, 0.18),
                        sky_scale: float = 1.0) -> np.ndarray:
    """Analytic gradient sky + sun disc, (H, 2H, 3) float32 (host, in
    float32 torch on the CPU so the arithmetic matches the reference's
    float32 bake)."""
    w = 2 * height
    f32 = torch.float32
    v, u = torch.meshgrid((torch.arange(height, dtype=f32) + 0.5) / height,
                          (torch.arange(w, dtype=f32) + 0.5) / w,
                          indexing="ij")
    d = uv_to_dir(torch.stack([u, v], dim=-1))
    y = d[..., 1]
    sky_t = torch.clamp(y, 0.0, 1.0) ** 0.65
    sky = mu.lerp(torch.tensor(horizon, dtype=f32),
                  torch.tensor(zenith, dtype=f32), sky_t[..., None])
    gnd = torch.tensor(ground, dtype=f32) * (
        0.4 + 0.6 * torch.clamp(-y, 0.0, 1.0))[..., None]
    col = torch.where((y >= 0.0)[..., None], sky, gnd) * sky_scale
    sd = torch.tensor(sun_dir, dtype=f32)
    sd = sd / torch.linalg.norm(sd)
    cos_sun = torch.sum(d * sd, dim=-1)
    in_sun = cos_sun > math.cos(sun_angular_radius)
    col = torch.where(in_sun[..., None], torch.tensor(sun_radiance, dtype=f32),
                      col)
    return col.numpy().astype(np.float32)
