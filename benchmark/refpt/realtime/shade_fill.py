"""The plain version of the port's K4 and its FILL variant (counterpart
of the port's pt/shade_kernel.py `shade_nee_plain`, `in_layout`,
`out_layout`, `pack_inputs`, `unpack_out`), copied whole: the realtime
frame's FILL pass calls it with fill=True. Planes in, planes out, in the
port's planar layout."""
from __future__ import annotations

import torch

from ..core import mathutils as mu
from ..pt import bsdf as B

W = torch.where
# light kinds (scene/lights.py)
_LIGHT_TRIANGLE, _LIGHT_POINT, _LIGHT_DIRECTIONAL = 0, 1, 2
_LIGHT_SPHERE, _LIGHT_SPOT = 3, 4
_K_MAX_RAY_TRAVEL = 1e15
MAX_NEE_SAMPLES = 2     # per kind; csrc/shade_kernel.cu instantiates 0..2


class Layout:
    """Named row ranges of a (C, N) plane stack."""

    def __init__(self):
        self.rows = 0
        self.map = {}

    def add(self, name: str, k: int = 1):
        self.map[name] = (self.rows, k)
        self.rows += k

    def get(self, planes, name):
        r, k = self.map[name]
        if k == 1:
            return planes[r]
        return tuple(planes[r + i] for i in range(k))


def in_layout(nee_distant: int, nee_local: int) -> Layout:
    """Input rows (the reference's `_in_layout`; csrc/shade_kernel.cu
    computes the same offsets)."""
    L = Layout()
    for name in ("pos", "n", "t", "b", "face_n", "vertex_n", "v",
                 "emission"):
        L.add(name, 3)
    L.add("front_facing")
    L.add("thin")
    L.add("shadow_fade")
    L.add("bd_diffuse", 3)
    L.add("bd_specular", 3)
    L.add("bd_rough")
    L.add("bd_metallic")
    L.add("bd_eta")
    L.add("bd_trans", 3)
    L.add("bd_dtrans")
    L.add("bd_strans")
    for name in ("thp", "radiance", "origin", "direction"):
        L.add(name, 3)
    for name in ("firefly_k", "emissive_mis", "env_mis", "cone_spread",
                 "diffuse_bounces", "vertex_index", "shade", "nee_skip",
                 "u_rr"):
        L.add(name)
    L.add("u3", 3)
    for i in range(nee_distant):
        L.add(f"ls_dir{i}", 3)
        L.add(f"ls_dist{i}")
        L.add(f"ls_li{i}", 3)
        L.add(f"ls_pdf{i}")
        L.add(f"ls_valid{i}")
    for j in range(nee_local):
        L.add(f"lrow_p0{j}", 3)
        L.add(f"lrow_e1{j}", 3)
        L.add(f"lrow_e2{j}", 3)
        L.add(f"lrow_pos{j}", 3)
        L.add(f"lrow_radius{j}")
        L.add(f"lrow_rad{j}", 3)
        L.add(f"lrow_inv_area{j}")
        L.add(f"lrow_kind{j}")
        L.add(f"lrow_axis{j}", 3)
        L.add(f"lrow_cos_cone{j}")
        L.add(f"lrow_soft{j}")
        L.add(f"pick_pdf{j}")
        L.add(f"u3l{j}", 3)
    return L


def out_layout(nee_distant: int, nee_local: int,
               fill: bool = False) -> Layout:
    """Output rows (the reference's `_out_layout`)."""
    L = Layout()
    for name in ("radiance", "thp", "origin", "direction"):
        L.add(name, 3)
    for name in ("firefly_k", "emissive_mis", "env_mis_pre", "cone_spread",
                 "diffuse_bounces", "lobe", "bs_pdf", "lobe_p",
                 "scatter_valid", "will_scatter", "rr_kill",
                 "non_delta_scatter"):
        L.add(name)
    L.add("vis_origin", 3)
    if fill:
        L.add("emission_term", 3)   # max(thp * em, 0) where shade
        L.add("pre_scatter_thp", 3)
    for i in range(nee_distant + nee_local):
        L.add(f"nee_dir{i}", 3)
        L.add(f"nee_dist{i}")
        L.add(f"nee_need{i}")
        if fill:
            L.add(f"nee_contrib_d{i}", 3)
            L.add(f"nee_contrib_s{i}", 3)
        else:
            L.add(f"nee_contrib{i}", 3)
    return L



def pack_inputs(L: Layout, n: int, values: dict) -> torch.Tensor:
    """Assemble (C_IN, N) from named (N,) / (N,k) tensors."""
    rows = [None] * L.rows
    for name, (r, k) in L.map.items():
        v = values[name]
        if k == 1:
            rows[r] = v.to(torch.float32).reshape(n)
        else:
            v = v.to(torch.float32)
            for i in range(k):
                rows[r + i] = v[..., i].reshape(n)
    return torch.stack(rows, dim=0)


def unpack_out(L: Layout, planes: torch.Tensor) -> dict:
    out = {}
    for name, (r, k) in L.map.items():
        out[name] = planes[r] if k == 1 else planes[r:r + k].t()
    return out


# ---- plain version ------------------------------------------------------

def _compute_ray_origin(pos, fn):
    """mathutils.compute_ray_origin, componentwise."""
    out = []
    for c in range(3):
        p, f = pos[c], fn[c]
        i_off = (f * (3.0 * 256.0)).to(torch.int32)
        shifted = p.contiguous().view(torch.int32) + W(p < 0.0, -i_off, i_off)
        i_pos = shifted.view(torch.float32)
        out.append(W(torch.abs(p) < (1.0 / 16.0), p + f * (3.0 / 65536.0),
                     i_pos))
    return tuple(out)


def _firefly_filter3(sig, threshold, k):
    t = threshold * k
    lum = B.luminance3(sig)
    s = t / B.maxs(lum, 1e-30)
    over = lum > t
    out = tuple(W(over, sig[i] * s, sig[i]) for i in range(3))
    enabled = threshold > 0.0
    return tuple(W(enabled, out[i], sig[i]) for i in range(3))


def _local_light_sample(g, pos, j: int):
    """lights.sample_local_lights with the light row fetched outside."""
    kind = g(f"lrow_kind{j}")
    p0, e1, e2 = g(f"lrow_p0{j}"), g(f"lrow_e1{j}"), g(f"lrow_e2{j}")
    pos_l = g(f"lrow_pos{j}")
    r_s = g(f"lrow_radius{j}")
    rad = g(f"lrow_rad{j}")
    inv_area = g(f"lrow_inv_area{j}")
    pick_pdf = g(f"pick_pdf{j}")
    u1, u2, u3 = g(f"u3l{j}")

    # triangle: uniform area sample
    su = torch.sqrt(u2)
    b1 = 1.0 - su
    b2 = u3 * su
    lp = B.add3(p0, B.add3(B.scale3(e1, b1), B.scale3(e2, b2)))
    fn = B.safe_normalize3(B.cross3(e1, e2))
    to_l = B.sub3(lp, pos)
    dist_sq = B.maxs(B.dot3(to_l, to_l), 1e-12)
    dist = torch.sqrt(dist_sq)
    dir_t = B.scale3(to_l, 1.0 / dist)
    cos_l = -B.dot3(fn, dir_t)
    pdf_tri = dist_sq * inv_area / B.maxs(cos_l, 1e-12)
    tri_visible = cos_l > 1e-6

    # point / spot
    to_p = B.sub3(pos_l, pos)
    dist_p_sq = B.maxs(B.dot3(to_p, to_p), 1e-12)
    dist_p = torch.sqrt(dist_p_sq)
    dir_p = B.scale3(to_p, 1.0 / dist_p)

    # sphere: uniform area sample over the surface
    z = 1.0 - 2.0 * u2
    s_ = torch.sqrt(B.maxs(1.0 - z * z, 0.0))
    phi = B.M_2PI * u3
    n_s = (s_ * torch.cos(phi), s_ * torch.sin(phi), z)
    lp_s = B.add3(pos_l, B.scale3(n_s, r_s))
    to_s = B.sub3(lp_s, pos)
    dist_s_sq = B.maxs(B.dot3(to_s, to_s), 1e-12)
    dist_s = torch.sqrt(dist_s_sq)
    dir_s = B.scale3(to_s, 1.0 / dist_s)
    cos_s = -B.dot3(n_s, dir_s)
    pdf_sph = dist_s_sq * inv_area / B.maxs(cos_s, 1e-12)
    sph_visible = cos_s > 1e-6

    dir_d = B.scale3(B.safe_normalize3(pos_l), -1.0)

    is_tri = kind == _LIGHT_TRIANGLE
    is_sph = kind == _LIGHT_SPHERE
    is_spot = kind == _LIGHT_SPOT
    is_pt = (kind == _LIGHT_POINT) | is_spot
    is_dir = kind == _LIGHT_DIRECTIONAL

    direction = B.where3(is_tri, dir_t,
                         B.where3(is_sph, dir_s, B.where3(is_pt, dir_p, dir_d)))
    distance = W(is_tri, dist, W(is_sph, dist_s,
                                 W(is_pt, dist_p, _K_MAX_RAY_TRAVEL)))
    pdf = W(is_tri, pdf_tri * pick_pdf, W(is_sph, pdf_sph * pick_pdf,
                                          pick_pdf))
    axis = g(f"lrow_axis{j}")
    cos_theta = -B.dot3(axis, dir_p)
    soft = g(f"lrow_soft{j}")
    cos_cone = g(f"lrow_cos_cone{j}")
    tshape = torch.clamp((cos_theta - cos_cone) / B.maxs(soft, 1e-6),
                         0.0, 1.0)
    shape_s = W(soft > 1e-6, tshape * tshape * (3.0 - 2.0 * tshape),
                (cos_theta >= cos_cone).to(torch.float32))
    shape = W(is_spot, shape_s, 1.0)
    inv_pick = 1.0 / B.maxs(pick_pdf, 1e-20)
    inv_pdf = 1.0 / B.maxs(pdf, 1e-20)
    li = tuple(W(is_tri | is_sph, rad[i] * inv_pdf,
                 W(is_pt, rad[i] * shape / dist_p_sq * inv_pick,
                   rad[i] * inv_pick)) for i in range(3))
    valid = (is_tri & tri_visible) | (is_sph & sph_visible) | is_pt | is_dir
    return direction, distance, li, pdf, valid, is_pt | is_dir


def shade_nee_plain(planes_in, consts4, *, nee_distant: int, nee_local: int,
                    rr: bool, max_bounces: int, max_diffuse_bounces: int,
                    spec_rough_threshold: float, local_pdf_k: float,
                    fill: bool = False):
    """Plain version of K4 (fill=True: its FILL variant): (C_IN, N)
    planes -> (C_OUT, N) planes."""
    Lin = in_layout(nee_distant, nee_local)
    Lout = out_layout(nee_distant, nee_local, fill)
    n = planes_in.shape[1]
    out = torch.empty((Lout.rows, n), dtype=torch.float32,
                      device=planes_in.device)
    gi = lambda name: Lin.get(planes_in, name)

    def po(name, val):
        r, k = Lout.map[name]
        if k == 1:
            out[r] = val
        else:
            for i in range(k):
                out[r + i] = val[i]

    firefly_threshold = consts4[0]
    atten = consts4[1]
    nee_min_rad = consts4[2]

    shade = gi("shade") != 0.0
    thp = gi("thp")
    radiance = gi("radiance")
    firefly_k0 = gi("firefly_k")

    # emission with MIS (PathTracer.hlsli:456-468)
    em = B.scale3(gi("emission"), gi("emissive_mis"))
    em = _firefly_filter3(em, firefly_threshold, firefly_k0)
    em = B.scale3(em, atten)
    add = B.mul3(thp, em)
    add = tuple(W(shade, B.maxs(add[i], 0.0), 0.0) for i in range(3))
    if fill:
        # FILL: emission on and off the stable branch is routed outside
        po("emission_term", add)
    else:
        radiance = tuple(radiance[i] + add[i] for i in range(3))

    vertex_index = gi("vertex_index")
    diffuse_bounces0 = gi("diffuse_bounces")
    finished = (vertex_index > float(max_bounces)) | \
        (diffuse_bounces0 > float(max_diffuse_bounces))

    # Russian roulette (:125-149)
    if rr:
        prob = B.sat(0.8 - B.luminance3(thp))
        prob = prob * prob
        prob = prob * prob
        rr_kill = gi("u_rr") < prob
        keep = shade & ~rr_kill
        inv1p = 1.0 / (1.0 - prob)
        thp = tuple(W(keep, thp[i] * inv1p, thp[i]) for i in range(3))
    else:
        rr_kill = torch.zeros_like(shade)

    pre_scatter_thp = thp
    will_scatter = shade & ~finished & ~rr_kill

    # BSDF make + sample (GenerateScatterRay)
    n_, t_, b_ = gi("n"), gi("t"), gi("b")
    bd = dict(diffuse=gi("bd_diffuse"), specular=gi("bd_specular"),
              rough=gi("bd_rough"), metallic=gi("bd_metallic"),
              eta=gi("bd_eta"), trans=gi("bd_trans"),
              dtrans=gi("bd_dtrans"), strans=gi("bd_strans"))
    thin = gi("thin") != 0.0
    v = gi("v")
    bb = B.make_bsdf(bd, B.dot3(v, n_), thin)
    wi = B.to_local(v, t_, b_, n_)
    bs = B.sample(bb, wi, gi("u3"))
    wo_world = B.from_local(bs["wo"], t_, b_, n_)
    lobe_i = bs["lobe"].to(torch.int32)
    is_delta = (lobe_i & B.LOBE_DELTA) != 0
    is_reflection = (lobe_i & B.LOBE_REFLECTION) != 0
    scatter_thp = B.mul3(thp, bs["weight"])
    scatter_valid = bs["valid"] & ((scatter_thp[0] > 0.0)
                                   | (scatter_thp[1] > 0.0)
                                   | (scatter_thp[2] > 0.0))
    rough_props = W(bb["alpha"] < B.K_MIN_GGX_ALPHA, 0.0, bb["roughness"])
    is_diffuse_bounce = is_reflection & (
        ((lobe_i & B.LOBE_DIFFUSE_REFLECTION) != 0)
        | (rough_props > float(spec_rough_threshold)))
    diffuse_bounces = diffuse_bounces0 + W(will_scatter & is_diffuse_bounce,
                                           1.0, 0.0)

    cone_spread0 = gi("cone_spread")
    cone_spread = W(will_scatter & ~is_delta,
                    torch.clamp(cone_spread0
                                + mu.spread_angle_from_scatter_pdf(
                                    bs["pdf"], 0.15), max=B.M_2PI),
                    cone_spread0)
    firefly_k = W(will_scatter, mu.new_scatter_firefly_filter_k(
        firefly_k0, bs["pdf"], bs["lobe_p"]), firefly_k0)

    face_n = gi("face_n")
    front = gi("front_facing") != 0.0
    neg_fn = B.scale3(face_n, -1.0)
    fn_r = B.where3(front == is_reflection, face_n, neg_fn)
    pos = gi("pos")
    origin = B.where3(will_scatter, _compute_ray_origin(pos, fn_r),
                      gi("origin"))
    direction = B.where3(will_scatter, wo_world, gi("direction"))
    thp = B.where3(will_scatter, scatter_thp, thp)
    # visibility-ray origin: view side of the surface
    vis_origin = _compute_ray_origin(pos, B.where3(front, face_n, neg_fn))

    # NEE (PathTracerNEE.hlsli:155-344)
    emissive_mis = W(shade, 1.0, gi("emissive_mis"))
    env_mis_pre = W(shade, 1.0, gi("env_mis"))
    vertex_n = gi("vertex_n")
    shadow_fade = gi("shadow_fade")
    nee_ok = shade & ~finished & ~rr_kill & (gi("nee_skip") == 0.0)

    def nee_one(ls_dir, ls_dist, ls_li, light_mis_pdf, ls_pdf, ls_valid,
                sample_weight, idx, ls_delta=None):
        wo_nee = B.to_local(ls_dir, t_, b_, n_)
        fd, fs, scatter_pdf = B.eval_split_pdf(bb, wi, wo_nee)
        mis = mu.eval_mis(1.0, light_mis_pdf / sample_weight, 1.0, scatter_pdf)
        if ls_delta is not None:
            # delta lights are unreachable by scatter rays: MIS weight 1
            mis = W(ls_delta, 1.0, mis)
        li = B.scale3(ls_li, mis * sample_weight)
        pdf_ff = ls_pdf / sample_weight
        lum = B.luminance3(B.mul3(B.add3(fd, fs), li))
        need = nee_ok & ls_valid & (lum > nee_min_rad)
        nee_k = mu.new_scatter_firefly_filter_k(firefly_k0, pdf_ff,
                                                torch.ones_like(pdf_ff))
        grazing = W(shadow_fade > 0.0,
                    B.sat((B.dot3(ls_dir, vertex_n) - shadow_fade)
                          / (2.0 * shadow_fade)), 1.0)
        dr = _firefly_filter3(B.mul3(fd, li), firefly_threshold, nee_k)
        sr = _firefly_filter3(B.mul3(fs, li), firefly_threshold, nee_k)

        def finish(sig):
            c = B.scale3(sig, grazing)
            c = B.mul3(pre_scatter_thp, c)
            c = B.scale3(c, atten)
            return tuple(W(need, B.maxs(x, 0.0), 0.0) for x in c)

        po(f"nee_dir{idx}", ls_dir)
        po(f"nee_dist{idx}", ls_dist * (1.0 - 1e-4))
        po(f"nee_need{idx}", need.to(torch.float32))
        if fill:
            # diffuse and specular apart, for the per-plane channels
            po(f"nee_contrib_d{idx}", finish(dr))
            po(f"nee_contrib_s{idx}", finish(sr))
        else:
            po(f"nee_contrib{idx}", finish(B.add3(dr, sr)))

    idx = 0
    for i in range(nee_distant):
        ls_pdf = gi(f"ls_pdf{i}")
        nee_one(gi(f"ls_dir{i}"), gi(f"ls_dist{i}"), gi(f"ls_li{i}"),
                ls_pdf, ls_pdf, gi(f"ls_valid{i}") != 0.0,
                1.0 / float(nee_distant), idx)
        idx += 1
    for j in range(nee_local):
        d_l, dist_l, li_l, pdf_l, ok_l, delta_l = _local_light_sample(
            gi, pos, j)
        lk = torch.full_like(pdf_l, float(local_pdf_k))
        nee_one(d_l, dist_l, li_l, lk, pdf_l, ok_l, 1.0 / float(nee_local),
                idx, ls_delta=delta_l)
        idx += 1

    # scatter-side MIS for the next segment (NEE.hlsli:248-280)
    non_delta_scatter = scatter_valid & ~is_delta
    if nee_local:
        em_w = mu.eval_mis(1.0, bs["pdf"], float(nee_local),
                         torch.full_like(bs["pdf"], float(local_pdf_k)))
        emissive_mis = W(shade & non_delta_scatter, em_w, emissive_mis)

    po("radiance", radiance)
    po("thp", thp)
    po("origin", origin)
    po("direction", direction)
    po("firefly_k", firefly_k)
    po("emissive_mis", emissive_mis)
    po("env_mis_pre", env_mis_pre)
    po("cone_spread", cone_spread)
    po("diffuse_bounces", diffuse_bounces)
    po("lobe", bs["lobe"])
    po("bs_pdf", bs["pdf"])
    po("lobe_p", bs["lobe_p"])
    po("scatter_valid", scatter_valid.to(torch.float32))
    po("will_scatter", will_scatter.to(torch.float32))
    po("rr_kill", rr_kill.to(torch.float32))
    po("non_delta_scatter", (shade & non_delta_scatter).to(torch.float32))
    po("vis_origin", vis_origin)
    if fill:
        po("pre_scatter_thp", pre_scatter_thp)
    return out
