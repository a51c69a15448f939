"""The Falcor standard BSDF in component form (counterpart of
rtxpt_tpu/pt/bsdf.py, in the component form of the reference's shade
megakernel, rtxpt_tpu/pt/shade_kernel.py).

Vectors are tuples of three (N,) float32 tensors, as the plain shade
pass (pt/shade_kernel.py) takes them. Reference configuration
(BxDFConfig.hlsli, BxDF.hlsli:37-54): Frostbite diffuse, Smith-GGX
correlated masking, bounded-VNDF sampling, delta lobes enabled,
kMinGGXAlpha = 0.0064, diffuse/specular split eval; all lobes active.
"""
from __future__ import annotations

import math

import torch

K_MIN_COS_THETA = 1e-6
K_MIN_GGX_ALPHA = 0.0064
ONE_MINUS_EPS = float.fromhex("0x1.fffffep-1")
M_PI = math.pi
M_2PI = 2.0 * math.pi
M_1_PI = 1.0 / math.pi
M_PI_4 = math.pi / 4.0
M_PI_2 = math.pi / 2.0
FLT_MAX = 3.402823466e38

# LobeType (LobeType.hlsli)
LOBE_NONE = 0x00
LOBE_DIFFUSE_REFLECTION = 0x01
LOBE_SPECULAR_REFLECTION = 0x02
LOBE_DELTA_REFLECTION = 0x04
LOBE_DIFFUSE_TRANSMISSION = 0x10
LOBE_SPECULAR_TRANSMISSION = 0x20
LOBE_DELTA_TRANSMISSION = 0x40
LOBE_DIFFUSE = 0x11
LOBE_SPECULAR = 0x22
LOBE_DELTA = 0x44
LOBE_NON_DELTA = 0x33
LOBE_REFLECTION = 0x0F
LOBE_TRANSMISSION = 0xF0
LOBE_ALL = 0xFF

W = torch.where


# ---- component-form vector helpers -----------------------------------

def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul3(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def where3(c, a, b):
    return (W(c, a[0], b[0]), W(c, a[1], b[1]), W(c, a[2], b[2]))


def maxs(x, s):
    return torch.clamp(x, min=s)


def sat(x):
    return torch.clamp(x, 0.0, 1.0)


def normalize3(a, eps=1e-20):
    inv = 1.0 / maxs(torch.sqrt(dot3(a, a)), eps)
    return scale3(a, inv)


def safe_normalize3(a):
    l = torch.sqrt(dot3(a, a))
    n = scale3(a, 1.0 / maxs(l, 1e-20))
    ok = l > 1e-20
    zero = torch.zeros_like(l)
    return (W(ok, n[0], zero), W(ok, n[1], zero), W(ok, n[2], zero))


def luminance3(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def to_local(v, t, b, n):
    return (dot3(v, t), dot3(v, b), dot3(v, n))


def from_local(v, t, b, n):
    return (v[0] * t[0] + v[1] * b[0] + v[2] * n[0],
            v[0] * t[1] + v[1] * b[1] + v[2] * n[1],
            v[0] * t[2] + v[1] * b[2] + v[2] * n[2])


# ---- Fresnel / microfacet ---------------------------------------------

def fresnel_schlick3(f0, f90, cos_theta):
    c = maxs(1.0 - cos_theta, 0.0)
    c5 = c * c
    c5 = c5 * c5 * c
    return tuple(f0[i] + (f90 - f0[i]) * c5 for i in range(3))


def fresnel_schlick1(f0, f90, cos_theta):
    c = maxs(1.0 - cos_theta, 0.0)
    c5 = c * c
    c5 = c5 * c5 * c
    return f0 + (f90 - f0) * c5


def fresnel_dielectric(eta, cos_i):
    """Exact dielectric Fresnel; returns (F, cos_theta_t)."""
    flip = cos_i < 0.0
    eta = W(flip, 1.0 / maxs(eta, 1e-8), eta)
    ci = torch.abs(cos_i)
    sin_t_sq = eta * eta * (1.0 - ci * ci)
    tir = sin_t_sq > 1.0
    ct = torch.sqrt(maxs(1.0 - sin_t_sq, 0.0))
    denom_s = eta * ci + ct
    denom_p = eta * ct + ci
    rs = (eta * ci - ct) / W(torch.abs(denom_s) < 1e-12, 1e-12, denom_s)
    rp = (eta * ct - ci) / W(torch.abs(denom_p) < 1e-12, 1e-12, denom_p)
    f = 0.5 * (rs * rs + rp * rp)
    return W(tir, 1.0, f), W(tir, 0.0, ct)


def sample_ggx_bvndf(alpha, i, u0, u1):
    """Bounded-VNDF half-vector sampling (Microfacet.hlsli:185-207)."""
    i_std = normalize3((i[0] * alpha, i[1] * alpha, i[2]))
    phi = M_2PI * u0
    a = sat(alpha)
    s = 1.0 + torch.sqrt(i[0] * i[0] + i[1] * i[1])
    a2, s2 = a * a, s * s
    k = (1.0 - a2) * s2 / (s2 + a2 * i[2] * i[2])
    bz = W(i[2] > 0.0, k * i_std[2], i_std[2])
    z = (1.0 - u1) * (1.0 + bz) - bz
    sin_t = torch.sqrt(sat(1.0 - z * z))
    o_std = (sin_t * torch.cos(phi), sin_t * torch.sin(phi), z)
    m_std = add3(i_std, o_std)
    return normalize3((m_std[0] * alpha, m_std[1] * alpha, m_std[2]))


def eval_ndf_ggx(alpha, cos_theta):
    a2 = alpha * alpha
    d = (cos_theta * a2 - cos_theta) * cos_theta + 1.0
    return a2 / maxs(d * d * M_PI, 1e-30)


def eval_lambda_ggx(a2, cos_theta):
    cs = maxs(cos_theta, 1e-12)
    cos_sqr = cs * cs
    tan_sqr = maxs(1.0 - cos_sqr, 0.0) / cos_sqr
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + a2 * tan_sqr))
    return W(cos_theta <= 0.0, 0.0, lam)


def smith_ggx_correlated(alpha, cos_i, cos_o):
    a2 = alpha * alpha
    return 1.0 / maxs(
        1.0 + eval_lambda_ggx(a2, cos_i) + eval_lambda_ggx(a2, cos_o),
        1e-12)


def _bvndf_k(alpha, i):
    a = sat(alpha)
    s = 1.0 + torch.sqrt(i[0] * i[0] + i[1] * i[1])
    a2, s2 = a * a, s * s
    return (1.0 - a2) * s2 / (s2 + a2 * i[2] * i[2])


def pdf_ggx_bvndf(alpha, i, m):
    """Bounded-VNDF pdf (Microfacet.hlsli:105-128)."""
    ndf = eval_ndf_ggx(alpha, m[2])
    t = torch.sqrt((alpha * i[0]) * (alpha * i[0])
                   + (alpha * i[1]) * (alpha * i[1]) + i[2] * i[2])
    k = _bvndf_k(alpha, i)
    return ndf / maxs(2.0 * (k * i[2] + t), 1e-20)


# ---- FalcorBSDF ---------------------------------------------------------

def make_bsdf(bd, cos_v, thin):
    """FalcorBSDF::make (BxDF.hlsli:647-714), all lobes active.
    bd: dict of BSDFData components (diffuse, specular, rough, metallic,
    eta, trans, dtrans, strans)."""
    trans_albedo = where3(thin, bd["trans"],
                          tuple(torch.sqrt(maxs(bd["trans"][i], 0.0))
                                for i in range(3)))
    alpha = bd["rough"] * bd["rough"]
    alpha = W(alpha < K_MIN_GGX_ALPHA, 0.0, alpha)
    alpha_t = W(bd["eta"] == 1.0, 0.0, alpha)
    metallic_brdf = bd["metallic"] * (1.0 - bd["strans"])
    dielectric = (1.0 - bd["metallic"]) * (1.0 - bd["strans"])
    diffuse_w = luminance3(bd["diffuse"])
    specular_w = luminance3(fresnel_schlick3(bd["specular"], 1.0, cos_v))
    p_diff = diffuse_w * dielectric * (1.0 - bd["dtrans"])
    p_diff_t = diffuse_w * dielectric * bd["dtrans"]
    p_spec = specular_w * (metallic_brdf + dielectric)
    p_spec_t = bd["strans"]
    norm = p_diff + p_diff_t + p_spec + p_spec_t
    inv = W(norm > 0.0, 1.0 / maxs(norm, 1e-30), 0.0)
    return dict(diff_albedo=bd["diffuse"], spec_albedo=bd["specular"],
                trans_albedo=trans_albedo, alpha=alpha, alpha_t=alpha_t,
                eta=bd["eta"], roughness=bd["rough"],
                diff_trans=bd["dtrans"], spec_trans=bd["strans"],
                p_diffuse=p_diff * inv, p_diffuse_t=p_diff_t * inv,
                p_specular=p_spec * inv, p_specular_t=p_spec_t * inv)


def frostbite_weight(wi, wo, roughness):
    h = safe_normalize3(add3(wi, wo))
    wo_dot_h = dot3(wo, h)
    energy_bias = 0.5 * roughness
    energy_factor = 1.0 + (1.0 / 1.51 - 1.0) * roughness
    fd90 = energy_bias + 2.0 * wo_dot_h * wo_dot_h * roughness
    wi_sc = fresnel_schlick1(1.0, fd90, wi[2])
    wo_sc = fresnel_schlick1(1.0, fd90, wo[2])
    return wi_sc * wo_sc * energy_factor


def _trans_half(b, wi, wo):
    """Half vector of the reflection+transmission lobe, flipped to +z."""
    is_refl = wo[2] > 0.0
    h = add3(wo, scale3(wi, W(is_refl, 1.0, b["eta"])))
    h = safe_normalize3(h)
    return is_refl, scale3(h, W(h[2] >= 0.0, 1.0, -1.0))


def spec_eval(b, wi, wo):
    ok = (torch.minimum(wi[2], wo[2]) >= K_MIN_COS_THETA) & (b["alpha"] > 0.0)
    h = safe_normalize3(add3(wi, wo))
    wi_dot_h = dot3(wi, h)
    d = eval_ndf_ggx(b["alpha"], h[2])
    g = smith_ggx_correlated(b["alpha"], wi[2], wo[2])
    f = fresnel_schlick3(b["spec_albedo"], 1.0, wi_dot_h)
    s = d * g * 0.25 / maxs(wi[2], 1e-12)
    return tuple(W(ok, f[i] * s, 0.0) for i in range(3))


def spec_pdf(b, wi, wo):
    ok = (torch.minimum(wi[2], wo[2]) >= K_MIN_COS_THETA) & (b["alpha"] > 0.0)
    h = safe_normalize3(add3(wi, wo))
    return W(ok, pdf_ggx_bvndf(b["alpha"], wi, h), 0.0)


def spec_trans_eval(b, wi, wo):
    ok = (torch.minimum(wi[2], torch.abs(wo[2])) >= K_MIN_COS_THETA) & \
        (b["alpha_t"] > 0.0)
    is_refl, h = _trans_half(b, wi, wo)
    wi_dot_h = dot3(wi, h)
    wo_dot_h = dot3(wo, h)
    d = eval_ndf_ggx(b["alpha_t"], h[2])
    g = smith_ggx_correlated(b["alpha_t"], wi[2], torch.abs(wo[2]))
    f, _ = fresnel_dielectric(b["eta"], wi_dot_h)
    refl = f * d * g * 0.25 / maxs(wi[2], 1e-12)
    sqrt_denom = wo_dot_h + b["eta"] * wi_dot_h
    sd = W(torch.abs(sqrt_denom) < 1e-12, 1e-12, sqrt_denom)
    tterm = b["eta"] * b["eta"] * wi_dot_h * wo_dot_h / (
        maxs(wi[2], 1e-12) * (sd * sd))
    tr = (1.0 - f) * d * g * torch.abs(tterm)
    return tuple(W(ok, W(is_refl, refl, b["trans_albedo"][i] * tr), 0.0)
                 for i in range(3))


def spec_trans_pdf(b, wi, wo):
    ok = (torch.minimum(wi[2], torch.abs(wo[2])) >= K_MIN_COS_THETA) & \
        (b["alpha_t"] > 0.0)
    is_refl, h = _trans_half(b, wi, wo)
    wi_dot_h = dot3(wi, h)
    wo_dot_h = dot3(wo, h)
    f, _ = fresnel_dielectric(b["eta"], wi_dot_h)
    pdf = pdf_ggx_bvndf(b["alpha_t"], wi, h)
    pdf_r = W(wo_dot_h <= 0.0, 0.0, pdf * wi_dot_h / maxs(wo_dot_h, 1e-12))
    sqrt_denom = wo_dot_h + b["eta"] * wi_dot_h
    denom = maxs(sqrt_denom * sqrt_denom, 1e-20)
    pdf_t = W(wo_dot_h > 0.0, 0.0,
              pdf * wi_dot_h * 4.0 * torch.abs(wo_dot_h) / denom)
    pdf = W(is_refl, pdf_r, pdf_t)
    pdf = pdf * W(is_refl, f, 1.0 - f)
    return W(ok, torch.clamp(pdf, 0.0, FLT_MAX), 0.0)


def eval_pdf(b, wi, wo):
    """Mixture pdf of wo (FalcorBSDF::evalPdf)."""
    ok_d = torch.minimum(wi[2], wo[2]) >= K_MIN_COS_THETA
    pdf = b["p_diffuse"] * W(ok_d, M_1_PI * wo[2], 0.0)
    ok_dt = torch.minimum(wi[2], -wo[2]) >= K_MIN_COS_THETA
    pdf = pdf + b["p_diffuse_t"] * W(ok_dt, M_1_PI * -wo[2], 0.0)
    pdf = pdf + b["p_specular"] * spec_pdf(b, wi, wo)
    pdf = pdf + b["p_specular_t"] * spec_trans_pdf(b, wi, wo)
    return pdf


def eval_split_pdf(b, wi, wo):
    """Fused NEE eval: (diffuse f*cos, specular f*cos, mixture pdf)."""
    wi_z, wo_z = wi[2], wo[2]
    ok_d = (torch.minimum(wi_z, wo_z) >= K_MIN_COS_THETA) & \
        (b["p_diffuse"] > 0.0)
    w_fb = frostbite_weight(wi, wo, b["roughness"])
    base_d = W(ok_d, M_1_PI * wo_z, 0.0)
    f_diff = tuple(b["diff_albedo"][i] * base_d * w_fb for i in range(3))
    pdf = b["p_diffuse"] * base_d

    ok_dt = (torch.minimum(wi_z, -wo_z) >= K_MIN_COS_THETA) & \
        (b["p_diffuse_t"] > 0.0)
    base_dt = W(ok_dt, M_1_PI * -wo_z, 0.0)
    f_diff_t = tuple(b["trans_albedo"][i] * base_dt for i in range(3))
    pdf = pdf + b["p_diffuse_t"] * base_dt

    ok_s = (torch.minimum(wi_z, wo_z) >= K_MIN_COS_THETA) & (b["alpha"] > 0.0)
    h = safe_normalize3(add3(wi, wo))
    wi_dot_h = dot3(wi, h)
    d_s = eval_ndf_ggx(b["alpha"], h[2])
    g_s = smith_ggx_correlated(b["alpha"], wi_z, wo_z)
    f_s = fresnel_schlick3(b["spec_albedo"], 1.0, wi_dot_h)
    sv = d_s * g_s * 0.25 / maxs(wi_z, 1e-12)
    okp = ok_s & (b["p_specular"] > 0.0)
    f_spec = tuple(W(okp, f_s[i] * sv, 0.0) for i in range(3))
    pdf = pdf + W(ok_s, b["p_specular"] * pdf_ggx_bvndf(b["alpha"], wi, h),
                  0.0)

    ok_t = (torch.minimum(wi_z, torch.abs(wo_z)) >= K_MIN_COS_THETA) & \
        (b["alpha_t"] > 0.0)
    is_refl, h_t = _trans_half(b, wi, wo)
    wi_dot_ht = dot3(wi, h_t)
    wo_dot_ht = dot3(wo, h_t)
    d_t = eval_ndf_ggx(b["alpha_t"], h_t[2])
    g_t = smith_ggx_correlated(b["alpha_t"], wi_z, torch.abs(wo_z))
    f_t, _ = fresnel_dielectric(b["eta"], wi_dot_ht)
    refl = f_t * d_t * g_t * 0.25 / maxs(wi_z, 1e-12)
    sqrt_denom = wo_dot_ht + b["eta"] * wi_dot_ht
    sd = W(torch.abs(sqrt_denom) < 1e-12, 1e-12, sqrt_denom)
    tterm = b["eta"] * b["eta"] * wi_dot_ht * wo_dot_ht / (
        maxs(wi_z, 1e-12) * (sd * sd))
    tr = (1.0 - f_t) * d_t * g_t * torch.abs(tterm)
    okt = ok_t & (b["p_specular_t"] > 0.0)
    f_spec_t = tuple(W(okt, W(is_refl, refl, b["trans_albedo"][i] * tr),
                       0.0) for i in range(3))
    pdf_m = pdf_ggx_bvndf(b["alpha_t"], wi, h_t)
    pdf_r = W(wo_dot_ht <= 0.0, 0.0,
              pdf_m * wi_dot_ht / maxs(wo_dot_ht, 1e-12))
    denom = maxs(sqrt_denom * sqrt_denom, 1e-20)
    pdf_tr = W(wo_dot_ht > 0.0, 0.0,
               pdf_m * wi_dot_ht * 4.0 * torch.abs(wo_dot_ht) / denom)
    pdf_st = W(is_refl, pdf_r, pdf_tr)
    pdf_st = pdf_st * W(is_refl, f_t, 1.0 - f_t)
    pdf = pdf + W(ok_t, b["p_specular_t"] * torch.clamp(pdf_st, 0.0, FLT_MAX),
                  0.0)

    wd = (1.0 - b["spec_trans"]) * (1.0 - b["diff_trans"])
    wdt = (1.0 - b["spec_trans"]) * b["diff_trans"]
    ws = 1.0 - b["spec_trans"]
    wst = b["spec_trans"]
    diffuse = tuple(wd * f_diff[i] + wdt * f_diff_t[i] for i in range(3))
    specular = tuple(ws * f_spec[i] + wst * f_spec_t[i] for i in range(3))
    return diffuse, specular, pdf


def sample_cosine_hemisphere(u0, u1):
    ux = 2.0 * u0 - 1.0
    uy = 2.0 * u1 - 1.0
    use_x = torch.abs(ux) > torch.abs(uy)
    r = W(use_x, ux, uy)
    phi = W(use_x, (uy / W(ux == 0, 1.0, ux)) * M_PI_4,
            M_PI_2 - (ux / W(uy == 0, 1.0, uy)) * M_PI_4)
    dx = r * torch.cos(phi)
    dy = r * torch.sin(phi)
    zero = (ux == 0.0) & (uy == 0.0)
    dx = W(zero, ux, dx)
    dy = W(zero, uy, dy)
    z = torch.sqrt(torch.clamp(1.0 - (dx * dx + dy * dy), min=0.0))
    return (dx, dy, z)


def sample(b, wi, u3):
    """FalcorBSDF::sample (BxDF.hlsli:785-869), all lobes active: returns
    dict(wo, pdf, weight, lobe (float-encoded LobeType), lobe_p, valid)."""
    u0, u1, u_sel = u3
    c1 = b["p_diffuse"]
    c2 = c1 + b["p_diffuse_t"]
    c3 = c2 + b["p_specular"]
    sel_diff = u_sel < c1
    sel_difft = (~sel_diff) & (u_sel < c2)
    sel_spec = (~sel_diff) & (~sel_difft) & (u_sel < c3)
    sel_spect = (~sel_diff) & (~sel_difft) & (~sel_spec) & \
        (b["p_specular_t"] > 0.0)
    wi_z_ok = wi[2] >= K_MIN_COS_THETA

    wo_cos = sample_cosine_hemisphere(u0, u1)
    wo_dt = (wo_cos[0], wo_cos[1], -wo_cos[2])

    h_r = sample_ggx_bvndf(maxs(b["alpha"], 1e-8), wi, u0, u1)
    wi_dot_hr = dot3(wi, h_r)
    wo_sr = sub3(scale3(h_r, 2.0 * wi_dot_hr), wi)
    delta_r = b["alpha"] == 0.0
    wo_sr = where3(delta_r, (-wi[0], -wi[1], wi[2]), wo_sr)
    sr_valid = wi_z_ok & (delta_r | (wo_sr[2] >= K_MIN_COS_THETA))
    sr_pdf = W(delta_r, 0.0, spec_pdf(b, wi, wo_sr))
    se = spec_eval(b, wi, wo_sr)
    inv_srp = 1.0 / maxs(sr_pdf, 1e-20)
    fs_d = fresnel_schlick3(b["spec_albedo"], 1.0, wi[2])
    sr_weight = tuple(W(delta_r, fs_d[i], se[i] * inv_srp) for i in range(3))
    sr_lobe = W(delta_r, float(LOBE_DELTA_REFLECTION),
                float(LOBE_SPECULAR_REFLECTION))

    u_sel_st = torch.clamp((u_sel - c3) / maxs(b["p_specular_t"], 1e-20),
                           0.0, ONE_MINUS_EPS)
    delta_t = b["alpha_t"] == 0.0
    h_t = sample_ggx_bvndf(maxs(b["alpha_t"], 1e-8), wi, u0, u1)
    zero = torch.zeros_like(u0)
    one = torch.ones_like(u0)
    h_t = where3(delta_t, (zero, zero, one), h_t)
    wi_dot_ht = dot3(wi, h_t)
    f_t, cos_theta_t = fresnel_dielectric(b["eta"], wi_dot_ht)
    is_refl_t = u_sel_st < f_t
    st_lobe_p = W(delta_t, W(is_refl_t, f_t, 1.0 - f_t), 1.0)
    wo_st_r = sub3(scale3(h_t, 2.0 * wi_dot_ht), wi)
    wo_st_t = sub3(scale3(h_t, b["eta"] * wi_dot_ht - cos_theta_t),
                   scale3(wi, b["eta"]))
    wo_st = where3(is_refl_t, wo_st_r, wo_st_t)
    st_valid = wi_z_ok & (torch.abs(wo_st[2]) >= K_MIN_COS_THETA) & \
        ((wo_st[2] > 0.0) == is_refl_t)
    st_pdf = W(delta_t, 0.0, spec_trans_pdf(b, wi, wo_st))
    delta_w = where3(is_refl_t, (one, one, one), b["trans_albedo"])
    ste = spec_trans_eval(b, wi, wo_st)
    inv_stp = 1.0 / maxs(st_pdf, 1e-20)
    rough_ok = st_pdf > 0.0
    st_weight = tuple(W(delta_t, delta_w[i], W(rough_ok, ste[i] * inv_stp,
                                                0.0)) for i in range(3))
    st_lobe = W(is_refl_t,
                W(delta_t, float(LOBE_DELTA_REFLECTION),
                  float(LOBE_SPECULAR_REFLECTION)),
                W(delta_t, float(LOBE_DELTA_TRANSMISSION),
                  float(LOBE_SPECULAR_TRANSMISSION)))

    wo = where3(sel_diff, wo_cos,
                where3(sel_difft, wo_dt, where3(sel_spec, wo_sr, wo_st)))

    d_valid = wi_z_ok & (wo_cos[2] >= K_MIN_COS_THETA)
    wfb = frostbite_weight(wi, wo_cos, b["roughness"])
    wd = (1.0 - b["spec_trans"]) * (1.0 - b["diff_trans"]) \
        / maxs(b["p_diffuse"], 1e-20)
    d_weight = tuple(b["diff_albedo"][i] * wfb * wd for i in range(3))
    dt_valid = wi_z_ok & (-wo_dt[2] >= K_MIN_COS_THETA)
    wdt = (1.0 - b["spec_trans"]) * b["diff_trans"] \
        / maxs(b["p_diffuse_t"], 1e-20)
    dt_weight = tuple(b["trans_albedo"][i] * wdt for i in range(3))
    ws = (1.0 - b["spec_trans"]) / maxs(b["p_specular"], 1e-20)
    s_weight = tuple(sr_weight[i] * ws for i in range(3))
    wst = b["spec_trans"] / maxs(b["p_specular_t"], 1e-20)
    t_weight = tuple(st_weight[i] * wst for i in range(3))

    valid = (sel_diff & d_valid) | (sel_difft & dt_valid) | \
        (sel_spec & sr_valid) | (sel_spect & st_valid)
    weight = where3(sel_diff, d_weight,
                    where3(sel_difft, dt_weight,
                           where3(sel_spec, s_weight,
                                  where3(sel_spect, t_weight,
                                         (zero, zero, zero)))))
    pdf = eval_pdf(b, wi, wo)
    lobe = W(sel_diff, float(LOBE_DIFFUSE_REFLECTION),
             W(sel_difft, float(LOBE_DIFFUSE_TRANSMISSION),
               W(sel_spec, sr_lobe, st_lobe)))
    lobe_p = W(sel_diff, b["p_diffuse"],
               W(sel_difft, b["p_diffuse_t"],
                 W(sel_spec, b["p_specular"],
                   st_lobe_p * b["p_specular_t"])))
    is_delta = (lobe.to(torch.int32) & LOBE_DELTA) != 0
    pdf = W(is_delta | ~valid, 0.0, pdf)
    weight = tuple(W(valid, weight[i], 0.0) for i in range(3))
    return dict(wo=wo, pdf=pdf, weight=weight, lobe=lobe, lobe_p=lobe_p,
                valid=valid)
