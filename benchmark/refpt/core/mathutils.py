"""Vector math helpers of the path tracer (counterpart of
rtxpt_tpu/core/mathutils.py): the subset the reference-mode slice uses.

Vectors are float32 tensors with a trailing 3-component axis; every
function broadcasts over leading (wavefront) dimensions.
"""
from __future__ import annotations

import torch

M_PI = 3.14159265358979323846
M_2PI = 2.0 * M_PI
M_PI_2 = M_PI / 2.0
M_PI_4 = M_PI / 4.0
# Maximum ray travel distance (reference: PathTracerTypes.hlsli kMaxRayTravel)
K_MAX_RAY_TRAVEL = 1e15
_TINY = torch.finfo(torch.float32).tiny


def dot(a, b, keepdim: bool = True):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def length(v, keepdim: bool = True):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim), min=0.0))


def normalize(v):
    return v / torch.clamp(length(v), min=_TINY)


def safe_normalize(v, fallback=None):
    l = length(v)
    n = v / torch.clamp(l, min=1e-20)
    return torch.where(l > 1e-20, n,
                       torch.zeros_like(v) if fallback is None else fallback)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def lerp(a, b, t):
    return a + (b - a) * t


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def luminance(rgb):
    """Relative luminance, ITU-R BT.709 (reference: Utils.hlsli:25)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def perp_stark(u):
    """A vector perpendicular to u (Stark 2009; MathHelpers.hlsli)."""
    a = torch.abs(u)
    xm = ((a[..., 0] - a[..., 1]) < 0) & ((a[..., 0] - a[..., 2]) < 0)
    ym = ((a[..., 1] - a[..., 2]) < 0) & (~xm)
    zm = ~(xm | ym)
    sel = torch.stack([xm, ym, zm], dim=-1).to(u.dtype)
    return cross(u, sel)


def sample_disk_concentric(u):
    """Shirley's concentric disk mapping (MathHelpers.hlsli:288)."""
    u = 2.0 * u - 1.0
    ux, uy = u[..., 0], u[..., 1]
    use_x = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_x, ux, uy)
    one = torch.ones_like(ux)
    phi = torch.where(
        use_x, (uy / torch.where(ux == 0, one, ux)) * M_PI_4,
        M_PI_2 - (ux / torch.where(uy == 0, one, uy)) * M_PI_4)
    d = r[..., None] * torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    zero = (ux == 0.0) & (uy == 0.0)
    return torch.where(zero[..., None], u, d)


def compute_ray_origin(pos, face_normal):
    """Offset a ray origin along the face normal (PathTracerHelpers.hlsli:
    22-42; Ray Tracing Gems ch.6): integer offset of the float32 bit
    pattern, small float offset near the origin. Bit-exact."""
    i_off = (face_normal * (3.0 * 256.0)).to(torch.int32)
    pos_bits = pos.contiguous().view(torch.int32)
    shifted = pos_bits + torch.where(pos < 0.0, -i_off, i_off)
    i_pos = shifted.view(torch.float32)
    f_off = face_normal * (3.0 / 65536.0)
    return torch.where(torch.abs(pos) < (1.0 / 16.0), pos + f_off, i_pos)


def eval_mis(n0, p0, n1, p1):
    """Balance-heuristic MIS weight for strategy 0 of two."""
    q0 = n0 * p0
    q1 = n1 * p1
    return saturate(q0 / torch.clamp(q0 + q1, min=1e-30))


def firefly_filter(signal, threshold, firefly_filter_k):
    """Biased luminance cap (PathTracerHelpers.hlsli:206-216); threshold
    (a float or a 0-d tensor) <= 0 disables."""
    if not torch.is_tensor(threshold) and not threshold > 0.0:
        return signal
    t = threshold * firefly_filter_k
    lum = luminance(signal)
    scaled = signal / torch.clamp(lum, min=1e-30)[..., None] * t[..., None]
    return torch.where(((threshold > 0.0) & (lum > t))[..., None], scaled,
                       signal)


def acos_approx(x):
    """Abramowitz-Stegun 4.4.45 arccos (|err| <= 6.8e-5 rad), as the
    reference's cone-spread and firefly heuristics use it."""
    ax = torch.abs(x)
    p = 1.5707288 + ax * (-0.2121144 + ax * (0.0742610 + ax * -0.0187293))
    r = torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * p
    return torch.where(x >= 0.0, r, M_PI - r)


def spread_angle_from_scatter_pdf(scatter_pdf, growth_factor=0.15):
    """Cone spread expansion from a scatter pdf, uniform-cap heuristic
    (PathTracerHelpers.hlsli:189)."""
    safe = torch.clamp(scatter_pdf, min=1e-30)
    return growth_factor * 2.0 * acos_approx(
        torch.clamp(1.0 - (1.0 / safe) / M_2PI, -1.0, 1.0))


def new_scatter_firefly_filter_k(current_k, bounce_pdf, lobe_p):
    """PathTracerHelpers.hlsli:195-203."""
    angle = torch.where(bounce_pdf == 0.0, 0.0,
                        spread_angle_from_scatter_pdf(bounce_pdf, 1.0))
    p = 32.0 / (32.0 + angle * angle)
    p = p * torch.sqrt(torch.clamp(lobe_p, min=0.0))
    return torch.clamp(current_k * p, min=1e-4)


def _spread_bits16(x):
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def morton2d(px, py):
    """Z-order key from 16-bit pixel coords (int64 tensors)."""
    return _spread_bits16(px.to(torch.int64)) | (
        _spread_bits16(py.to(torch.int64)) << 1)
