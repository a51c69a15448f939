"""Environment light: baked radiance map + importance sampling
(counterpart of rtxpt_tpu/scene/envmap.py; Distant.hlsli EnvMap::Eval and
EnvMapSampler, EnvMapImportanceSamplingBaker).

Equirectangular (H, 2H, 3) radiance. The host build (numpy) derives the
row tables the device path reads, all through the row gather of
`ops/gather.py`:
  * radiance_quad (H*W, 12): [self, right, down, diag] RGB per texel, so a
    bilinear eval is one row fetch + lerp;
  * alias_pack (H*W, 10): Vose alias rows [prob, alias, pdf_self,
    pdf_alias, le_self(3), le_alias(3)] over the luminance x solid-angle
    texel pmf of the MIP-descent sampler, so a distant-light draw is one
    row fetch and `pdf_mip_descent` reads pdf_self of the same rows.
The true hierarchical descent (`sample_mip_descent`) reads a luminance
pyramid of its own, built on request by `build_mip_pyramid`: no render
path draws through it.

The distant samplers of NEE (PathTracerNEE.hlsli:70-108): `sample_uniform`
(NEE_DISTANT_UNIFORM), `sample_importance` (MIP-descent through the
alias rows) and `sample_presampled` over a per-sample `presample` list.
`load_equirect` reads a user's Radiance .hdr.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

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


def _texel_weights(radiance: np.ndarray):
    """(omega, base) of an (H, 2H, 3) radiance map: each row's texel solid
    angle and the luminance x solid-angle texel weights, the finest level
    of the MIP pyramid."""
    h, w = radiance.shape[0], radiance.shape[1]
    if w != 2 * h or h & (h - 1):
        raise ValueError(f"equirect must be (H, 2H) with H a power of two, "
                         f"got {radiance.shape}")
    omega = _row_solid_angles(h, w)
    lum = (0.2126 * radiance[..., 0] + 0.7152 * radiance[..., 1]
           + 0.0722 * radiance[..., 2])
    return omega, lum * omega[:, None]


def build_tables(radiance: np.ndarray):
    """(radiance_quad, alias_pack) of an (H, 2H, 3) radiance map: the
    reference's `_make_envmap_np` restricted to what the device reads."""
    radiance = np.asarray(radiance, np.float32)
    omega, base = _texel_weights(radiance)
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
                device="cuda") -> EnvMap:
    radiance = np.asarray(radiance, np.float32)
    quad, alias = build_tables(radiance)
    return EnvMap(radiance_quad=torch.as_tensor(quad, device=device),
                  alias_pack=torch.as_tensor(alias, device=device),
                  height=radiance.shape[0], width=radiance.shape[1],
                  intensity=float(intensity), enabled=bool(enabled))


@dataclasses.dataclass
class MipPyramid:
    """The luminance x solid-angle pyramid of an env map for
    `sample_mip_descent`: its (1, 2) top level and, per finer level, the
    four child weights [w00, w01, w10, w11] of each parent texel, one row
    per parent."""
    top: torch.Tensor     # (2,) f32
    quads: tuple          # per level l >= 1: (h_{l-1} w_{l-1}, 4) f32


def build_mip_pyramid(radiance, device="cuda") -> MipPyramid:
    """The MIP pyramid of the (H, 2H, 3) radiance map an EnvMap was made
    from (the reference's `mips`, float32)."""
    _, m = _texel_weights(np.asarray(radiance, np.float32))
    quads = []
    while m.shape[0] > 1:
        q = (m[0::2, 0::2], m[0::2, 1::2], m[1::2, 0::2], m[1::2, 1::2])
        quads.append(np.stack(q, axis=-1).reshape(-1, 4).astype(np.float32))
        m = q[0] + q[1] + q[2] + q[3]
    t = lambda a: torch.as_tensor(a, device=device)
    return MipPyramid(top=t(m.reshape(-1).astype(np.float32)),
                      quads=tuple(t(q) for q in quads[::-1]))


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


def sample_uniform(env: EnvMap, u2):
    """EnvMapSampler::UniformSample (Distant.hlsli:125-138)."""
    d = mu.sample_sphere_uniform(u2)
    pdf = torch.full(u2.shape[:-1], 1.0 / (4.0 * mu.M_PI),
                     dtype=torch.float32, device=u2.device)
    return d, pdf, eval_dir(env, d)


def pdf_uniform(env: EnvMap, d):
    return torch.full(d.shape[:-1], 1.0 / (4.0 * mu.M_PI),
                      dtype=torch.float32, device=d.device)


def sample_mip_descent(env: EnvMap, pyr: MipPyramid, u2):
    """EnvMapSampler::MIPDescentSample (Distant.hlsli:140-235): the
    hierarchical warp down the luminance pyramid `pyr` of `env`, one
    quad-row fetch per level; the same texel pmf as `sample_importance`,
    keeping the stratification of a low-discrepancy input. The texel's pdf
    and radiance come from its alias row (pdf_self, le_self)."""
    shape = u2.shape[:-1]
    ux, uy = u2[..., 0], u2[..., 1]
    # the top level is (1, 2): pick the hemisphere column first
    p_left = pyr.top[0] / torch.clamp(pyr.top[0] + pyr.top[1], min=1e-20)
    go_right = ux >= p_left
    ix = go_right.to(torch.int32)
    iy = torch.zeros(shape, dtype=torch.int32, device=u2.device)
    ux = torch.where(go_right,
                     (ux - p_left) / torch.clamp(1.0 - p_left, min=1e-9),
                     ux / torch.clamp(p_left, min=1e-9))
    w_par = 2
    for q_tab in pyr.quads:
        q = gather.gather_rows(q_tab, iy * w_par + ix)
        w00, w01, w10, w11 = q.unbind(-1)
        left = w00 + w10
        right = w01 + w11
        p_l = left / torch.clamp(left + right, min=1e-20)
        go_r = ux >= p_l
        ux = torch.where(go_r, (ux - p_l) / torch.clamp(1.0 - p_l, min=1e-9),
                         ux / torch.clamp(p_l, min=1e-9))
        top = torch.where(go_r, w01, w00)
        bot = torch.where(go_r, w11, w10)
        p_t = top / torch.clamp(top + bot, min=1e-20)
        go_b = uy >= p_t
        uy = torch.where(go_b, (uy - p_t) / torch.clamp(1.0 - p_t, min=1e-9),
                         uy / torch.clamp(p_t, min=1e-9))
        ix = ix * 2 + go_r.to(torch.int32)
        iy = iy * 2 + go_b.to(torch.int32)
        w_par *= 2
    h, w = env.height, env.width
    # jitter within the texel with the residual sample
    uv = torch.stack([(ix + torch.clamp(ux, 0.0, 0.9999)) / w,
                      (iy + torch.clamp(uy, 0.0, 0.9999)) / h], dim=-1)
    row = gather.gather_rows(env.alias_pack, iy * w + ix)
    le = row[..., 4:7] * env.intensity
    if not env.enabled:
        le = torch.zeros_like(le)
    return uv_to_dir(uv), row[..., 2], le


def pdf_mip_descent(env: EnvMap, d):
    """EnvMapSampler::MIPDescentEvalPdf (Distant.hlsli:180-210): the
    solid-angle pdf of the texel d falls in (pdf_self of its alias row)."""
    uv = dir_to_uv(d)
    h, w = env.height, env.width
    x = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
    return gather.gather_rows(env.alias_pack, y * w + x)[..., 2]


@dataclasses.dataclass
class PresampledEnv:
    """Presampled light list (EnvMapImportanceSamplingBaker presampling;
    Config.h:86 ENVMAP_PRESAMPLED_COUNT 2048), drawn anew for each
    accumulation sample; PreSampledSample picks a random entry."""
    dirs: torch.Tensor   # (K, 3)
    le: torch.Tensor     # (K, 3)
    pdf: torch.Tensor    # (K,)


def presample(env: EnvMap, sample_index: int,
              count: int = 2048) -> PresampledEnv:
    """`count` importance draws of the low-discrepancy stream of lane
    (i, 9) at `sample_index`."""
    from ..core import rng
    idx = torch.arange(count, dtype=torch.int64,
                       device=env.alias_pack.device)
    g = rng.make(idx, torch.full_like(idx, 0x9), 0, sample_index & rng.M32)
    g, u2 = rng.next_2d(g)
    d, pdf, le = sample_importance(env, u2)
    return PresampledEnv(d, le, pdf)


def sample_presampled(env: EnvMap, pre: PresampledEnv, u1):
    """EnvMapSampler::PreSampledSample (Distant.hlsli:237-253):
    (direction, pdf, radiance) of entry floor(u1 * K)."""
    k = pre.dirs.shape[0]
    i = torch.clamp((u1 * k).to(torch.int64), 0, k - 1)
    return pre.dirs[i], pre.pdf[i], pre.le[i]


def load_equirect(path: str, target_height: Optional[int] = None):
    """An equirectangular environment from a Radiance .hdr file or an LDR
    .png (sRGB -> linear, as the reference's LDR path) (the EnvMapBaker
    "loaded texture" path), nearest-resampled to (H, 2H, 3) float32 with H
    a power of two (by default the largest one not above the file's
    height, between 8 and 1024). .exr and other images need packages the
    port does not depend on and raise NotImplementedError."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        img = _load_radiance_hdr(path)
    elif ext == ".png":
        from ..utils.image import load_png
        img = load_png(path) ** 2.2
    else:
        raise NotImplementedError(f"environment format {ext!r}: the port "
                                  "reads Radiance .hdr and .png")
    h0 = img.shape[0]
    if target_height is None:
        target_height = 1 << max(int(np.floor(np.log2(max(h0, 2)))), 3)
        target_height = min(target_height, 1024)
    th, tw = target_height, target_height * 2
    if img.shape[0] != th or img.shape[1] != tw:
        ys = (np.arange(th) + 0.5) / th * img.shape[0] - 0.5
        xs = (np.arange(tw) + 0.5) / tw * img.shape[1] - 0.5
        yi = np.clip(np.round(ys).astype(int), 0, img.shape[0] - 1)
        xi = np.clip(np.round(xs).astype(int), 0, img.shape[1] - 1)
        img = img[yi][:, xi]
    return np.ascontiguousarray(img, np.float32)


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) < n:
        raise ValueError("truncated .hdr")
    return b


def _load_radiance_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) decoder: new-style RLE and flat scanlines,
    -Y H +X W orientation. A cut-off file, or an RLE packet of length 0
    or one that runs past its scanline, raises ValueError."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a Radiance file")
        while True:
            line = f.readline()
            if line in (b"\n", b""):
                break
        dims = f.readline().split()
        if dims[0] != b"-Y":
            raise ValueError("unsupported .hdr orientation")
        h, w = int(dims[1]), int(dims[3])
        data = np.zeros((h, w, 4), np.uint8)
        for y in range(h):
            head = _read_exact(f, 4)
            if head[0] == 2 and head[1] == 2 and \
                    (head[2] << 8 | head[3]) == w:
                # new-style RLE: four separated component streams
                for c in range(4):
                    x = 0
                    while x < w:
                        n = _read_exact(f, 1)[0]
                        run = n > 128
                        n = n - 128 if run else n
                        if n == 0 or x + n > w:
                            raise ValueError(f"bad .hdr RLE packet in "
                                             f"scanline {y}")
                        data[y, x:x + n, c] = (
                            _read_exact(f, 1)[0] if run else
                            np.frombuffer(_read_exact(f, n), np.uint8))
                        x += n
            else:
                # flat scanline: head already holds the first pixel
                row = head + _read_exact(f, (w - 1) * 4)
                data[y] = np.frombuffer(row, np.uint8).reshape(w, 4)
    mant = data[..., :3].astype(np.float32)
    exp = data[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0,
                     np.ldexp(1.0, exp - 136)).astype(np.float32)
    return mant * scale[..., None]


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


def bake_atmospheric_sky(height: int = 128,
                         sun_dir=(0.35, 0.65, 0.2),
                         sun_irradiance: float = 22.0,
                         turbidity: float = 1.0,
                         altitude_m: float = 100.0,
                         ground_albedo=(0.25, 0.22, 0.20),
                         sun_angular_radius: float = 0.004675,
                         samples: int = 32, sun_samples: int = 8,
                         sky_scale: float = 1.0) -> np.ndarray:
    """Physically based sky: Rayleigh + Mie single scattering integrated
    at bake time, on the host in float64 numpy (the precomputed_sky.hlsli
    bake, driven per frame by EnvMapBaker::Update, Sample.cpp:1495-1521).
    Nishita geometry: spherical shells with exponential density profiles;
    each view ray is marched to the top of the atmosphere (or the ground)
    in `samples` steps, with a `sun_samples`-step transmittance march
    toward the sun at each. The ground is a sun-lit Lambertian seen
    through the atmosphere; the sun disc is the irradiance over its solid
    angle, attenuated along the view path. `turbidity` scales the Mie
    load. Returns (H, 2H, 3) float32 radiance."""
    re_, ra = 6360e3, 6460e3                # ground / atmosphere top
    hr, hm = 7994.0, 1200.0                 # scale heights
    beta_r = np.array([5.802e-6, 13.558e-6, 33.1e-6])   # Rayleigh scatter
    beta_m_s = 3.996e-6 * float(turbidity)              # Mie scatter
    beta_m_e = beta_m_s / 0.9                           # Mie extinction
    g = 0.76                                            # Mie anisotropy

    h, w = height, 2 * height
    v, u = np.meshgrid((np.arange(h) + 0.5) / h,
                       (np.arange(w) + 0.5) / w, indexing="ij")
    theta = v * np.pi
    phi = (u * 2.0 - 1.0) * np.pi
    st = np.sin(theta)
    d = np.stack([st * np.cos(phi), np.cos(theta), st * np.sin(phi)],
                 -1).reshape(-1, 3)
    sd = np.asarray(sun_dir, np.float64)
    sd = sd / np.linalg.norm(sd)
    origin = np.array([0.0, re_ + max(altitude_m, 1.0), 0.0])

    def transmittance_to_sun(pts):
        """Transmittance from each of pts (M,3) toward the sun; 0 where
        the planet blocks the sun."""
        b = pts @ sd
        r2 = np.sum(pts * pts, -1)
        t_exit = -b + np.sqrt(np.maximum(b * b - (r2 - ra * ra), 0.0))
        disc_g = b * b - (r2 - re_ * re_)
        blocked = (disc_g > 0.0) & (
            -b - np.sqrt(np.maximum(disc_g, 0.0)) > 0.0)
        ts = (np.arange(sun_samples) + 0.5) / sun_samples
        seg = t_exit / sun_samples
        od_r = np.zeros(pts.shape[0])
        od_m = np.zeros(pts.shape[0])
        for k in range(sun_samples):
            p = pts + sd * (ts[k] * t_exit)[..., None]
            alt = np.linalg.norm(p, axis=-1) - re_
            od_r += np.exp(-np.maximum(alt, 0.0) / hr) * seg
            od_m += np.exp(-np.maximum(alt, 0.0) / hm) * seg
        tr = np.exp(-(beta_r[None] * od_r[..., None]
                      + beta_m_e * od_m[..., None]))
        tr[blocked] = 0.0
        return tr

    # the view rays end at the top of the atmosphere or on the ground
    b = d @ origin
    t_end = -b + np.sqrt(np.maximum(b * b - (origin @ origin - ra * ra),
                                    0.0))
    disc_g = b * b - (origin @ origin - re_ * re_)
    hits_ground = (disc_g > 0.0) & (
        -b - np.sqrt(np.maximum(disc_g, 0.0)) > 0.0)
    t_ground = -b - np.sqrt(np.maximum(disc_g, 0.0))
    t_end = np.where(hits_ground, np.maximum(t_ground, 0.0), t_end)

    mu_c = d @ sd                                       # cos(sun angle)
    phase_r = 3.0 / (16.0 * np.pi) * (1.0 + mu_c ** 2)
    phase_m = 3.0 / (8.0 * np.pi) * ((1.0 - g * g) * (1.0 + mu_c ** 2)
                                     / ((2.0 + g * g) * (1.0 + g * g
                                        - 2.0 * g * mu_c) ** 1.5))
    seg = t_end / samples
    od_r = np.zeros(d.shape[0])
    od_m = np.zeros(d.shape[0])
    sum_r = np.zeros((d.shape[0], 3))
    sum_m = np.zeros((d.shape[0], 3))
    ts = (np.arange(samples) + 0.5) / samples
    for k in range(samples):
        p = origin[None] + d * (ts[k] * t_end)[..., None]
        alt = np.maximum(np.linalg.norm(p, axis=-1) - re_, 0.0)
        rho_r = np.exp(-alt / hr) * seg
        rho_m = np.exp(-alt / hm) * seg
        t_view = np.exp(-(beta_r[None] * (od_r + 0.5 * rho_r)[..., None]
                          + beta_m_e * (od_m + 0.5 * rho_m)[..., None]))
        t_sun = transmittance_to_sun(p)
        sum_r += rho_r[..., None] * t_view * t_sun
        sum_m += rho_m[..., None] * t_view * t_sun
        od_r += rho_r
        od_m += rho_m
    col = sun_irradiance * (sum_r * beta_r[None] * phase_r[..., None]
                            + sum_m * beta_m_s * phase_m[..., None])

    # ground: the sun-lit Lambertian, attenuated sun -> ground -> eye
    t_total = np.exp(-(beta_r[None] * od_r[..., None]
                       + beta_m_e * od_m[..., None]))
    gp = origin[None] + d * t_end[..., None]
    g_n = gp / np.maximum(np.linalg.norm(gp, axis=-1, keepdims=True), 1e-9)
    cos_g = np.maximum(g_n @ sd, 0.0)
    alb = np.asarray(ground_albedo, np.float64)
    ground_col = (alb[None] / np.pi) * sun_irradiance * \
        cos_g[..., None] * transmittance_to_sun(gp) * t_total
    col = np.where(hits_ground[..., None], col + ground_col, col)

    # the sun disc: irradiance over its solid angle, through the view path
    omega_sun = 2.0 * np.pi * (1.0 - np.cos(sun_angular_radius))
    in_sun = (mu_c > np.cos(sun_angular_radius)) & ~hits_ground
    col = np.where(in_sun[..., None],
                   col + t_total * (sun_irradiance / omega_sun), col)
    return (col * sky_scale).reshape(h, w, 3).astype(np.float32)


def bake_with_directional(base_radiance, directional_lights,
                          angular_radius: float = 0.02) -> np.ndarray:
    """EnvMapBaker::Update's splat of analytic directional lights
    (EnvMapBaker.cpp, per frame at Sample.cpp:1495-1521): each light
    becomes a disc of radiance = irradiance / solid angle in the
    equirect, so the env sampler and MIS see it as distant light.

    directional_lights: dicts {direction (the travel direction, from the
    light), radiance}. Returns a new (H, 2H, 3) float32 map."""
    col = np.asarray(base_radiance, np.float32).copy()
    h, w = col.shape[0], col.shape[1]
    v, u = np.meshgrid((np.arange(h) + 0.5) / h,
                       (np.arange(w) + 0.5) / w, indexing="ij")
    theta = v * np.pi
    phi = (u * 2.0 - 1.0) * np.pi
    st = np.sin(theta)
    d = np.stack([st * np.cos(phi), np.cos(theta), st * np.sin(phi)], -1)
    omega = 2.0 * np.pi * (1.0 - np.cos(angular_radius))
    for light in directional_lights:
        ld = np.asarray(light["direction"], np.float32)
        ld = -ld / max(np.linalg.norm(ld), 1e-9)      # toward the light
        rad = np.asarray(light["radiance"], np.float32) / omega
        mask = (d @ ld) > np.cos(angular_radius)
        col[mask] = col[mask] + rad
    return col
