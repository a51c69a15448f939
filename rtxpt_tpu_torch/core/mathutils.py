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


def safe_normalize(v):
    l = length(v)
    n = v / torch.clamp(l, min=1e-20)
    return torch.where(l > 1e-20, n, torch.zeros_like(v))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def lerp(a, b, t):
    return a + (b - a) * t


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def luminance(rgb):
    """Relative luminance, ITU-R BT.709 (reference: Utils.hlsli:25)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def reflect(i, n):
    """HLSL reflect: i - 2*dot(i,n)*n (i points toward the surface)."""
    return i - 2.0 * dot(i, n) * n


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


def sample_triangle_uniform(u):
    """Uniform barycentrics via the sqrt parameterization: (b0, b1, b2)."""
    su = torch.sqrt(u[..., 0])
    b1 = 1.0 - su
    b2 = u[..., 1] * su
    return torch.stack([1.0 - b1 - b2, b1, b2], dim=-1)


def _oct_wrap(v):
    return (1.0 - torch.abs(v.flip(-1))) * torch.where(v >= 0.0, 1.0, -1.0)


def encode_oct(n):
    """Octahedral encoding of a unit vector into [0,1]^2 (Utils.hlsli:56-77)."""
    n = n / (torch.abs(n[..., 0:1]) + torch.abs(n[..., 1:2])
             + torch.abs(n[..., 2:3]))
    xy = torch.where(n[..., 2:3] >= 0.0, n[..., :2], _oct_wrap(n[..., :2]))
    return xy * 0.5 + 0.5


def decode_oct(f):
    f = f * 2.0 - 1.0
    z = 1.0 - torch.abs(f[..., 0:1]) - torch.abs(f[..., 1:2])
    t = saturate(-z)
    xy = f + torch.where(f >= 0.0, -t, t)
    return normalize(torch.cat([xy, z], dim=-1))


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


def firefly_filter(signal, threshold: float, firefly_filter_k):
    """Biased luminance cap (PathTracerHelpers.hlsli:206-216);
    threshold <= 0 disables."""
    if not threshold > 0.0:
        return signal
    t = threshold * firefly_filter_k
    lum = luminance(signal)
    scaled = signal / torch.clamp(lum, min=1e-30)[..., None] * t[..., None]
    return torch.where((lum > t)[..., None], scaled, signal)


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


def _spread_bits10(x):
    """Spread the low 10 bits of x so bit i lands at bit 3i."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(qx, qy, qz):
    """Z-order key from 10-bit quantized 3D coords (int64 tensors; a
    30-bit key): orders secondary wavefront lanes by ray origin cell."""
    return (_spread_bits10(qx.to(torch.int64))
            | (_spread_bits10(qy.to(torch.int64)) << 1)
            | (_spread_bits10(qz.to(torch.int64)) << 2))
