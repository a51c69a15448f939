"""The FILL pass of the stable-planes frame (counterpart of the port's
pt/integrator.py `render_paths` under cfg.mode == MODE_FILL_STABLE_PLANES,
its fused `_shade_step` and `_on_scatter`; PathTracerStablePlanes.hlsli
FILL :248-462): the bounce loop resumes from each pixel's BUILD-stored
plane-0 base hit and routes emission, NEE and secondary radiance into the
per-plane diffuse / specular channels, and exports the secondary surface
and radiance that ReSTIR GI reuses.

One configuration: NEE on (MIP-descent distant, power local), the "ld"
sample generator, K4's FILL variant in its plain version, no exact alpha
test, one sample a pixel. The port's Morton order of the wavefront, its
tail compaction and its wavefront sorts move lanes only and are left
out."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import mathutils as mu
from ..core import raycone, rng
from ..ops import traverse
from ..ops.intersect import Hit
from ..pt import bsdf as B
from ..pt import nested, shading
from ..pt.integrator import (K_MAX_REJECTED_HITS, LOCAL_PDF_ESTIMATE_K,
                             K_SPECULAR_ROUGHNESS_THRESHOLD, _sample_distant)
from ..scene import envmap as EM
from ..scene import lights as LI
from . import shade_fill as SK
from . import stableplanes as SP


class PathState(NamedTuple):
    """PathState SoA (PathState.hlsli:82-222) with the FILL fields."""
    origin: torch.Tensor          # (N,3)
    direction: torch.Tensor       # (N,3)
    thp: torch.Tensor             # (N,3)
    radiance: torch.Tensor        # (N,3) path.L
    active: torch.Tensor          # (N,) bool
    vertex_index: torch.Tensor    # (N,) i32
    diffuse_bounces: torch.Tensor  # (N,) i32
    rejected_hits: torch.Tensor   # (N,) i32
    scene_length: torch.Tensor    # (N,)
    firefly_k: torch.Tensor       # (N,)
    cone_width: torch.Tensor      # (N,)
    cone_spread: torch.Tensor     # (N,)
    interior: torch.Tensor        # (N,2) i64 nested-dielectric stack
    emissive_mis: torch.Tensor    # (N,)
    env_mis: torch.Tensor         # (N,)
    px: torch.Tensor              # (N,) i64 pixel x
    py: torch.Tensor              # (N,) i64 pixel y
    sp_branch: torch.Tensor       # (N,) stableBranchID (u32 in i64)
    sp_plane: torch.Tensor        # (N,) i64 current plane index
    sp_on_plane: torch.Tensor     # (N,) bool
    sp_on_branch: torch.Tensor    # (N,) bool
    sp_on_dominant: torch.Tensor  # (N,) bool
    sp_base_diff: torch.Tensor    # (N,) bool base scatter diffuse
    sp_base_delta: torch.Tensor   # (N,) bool base scatter delta
    sp_gi_l: torch.Tensor         # (N,3) secondary L for ReSTIR GI
    sp_gi_pdf: torch.Tensor       # (N,) base scatter pdf
    sp_gi_valid: torch.Tensor     # (N,) bool GI-eligible base
    sp_gi_thp: torch.Tensor       # (N,3) throughput after the base scatter
    sp_delta_only: torch.Tensor   # (N,) bool delta-only since plane
    sp_bounces: torch.Tensor      # (N,) i64 bounces from the plane
    sp_hit_t: torch.Tensor        # (N,) accumulated sample hitT
    sp_pend_diff: torch.Tensor    # (N,4) pending diff radiance+hitT
    sp_pend_spec: torch.Tensor    # (N,4)
    sp_secondary_l: torch.Tensor  # (N,3)
    sp_committed_diff: torch.Tensor  # (N,P,4) per-plane channels
    sp_committed_spec: torch.Tensor  # (N,P,4)
    sp_plane_branch: torch.Tensor    # (N,P) plane branch ids
    sp_dominant: torch.Tensor        # (N,) i64 dominant plane


def initial_state(sp: SP.StablePlanes, cam, px, py, P: int) -> PathState:
    """The FILL wavefront at each pixel's plane-0 base
    (firstHitFromBasePlane; the port's models/realtime.py)."""
    n = px.shape[0]
    dev = px.device
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    z1 = torch.zeros((n,), dtype=torch.float32, device=dev)
    z4 = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    no = torch.zeros((n,), dtype=torch.bool, device=dev)
    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    dom = sp.dominant
    base_valid = sp.prim[:, 0] >= 0
    return PathState(
        origin=z3, direction=sp.ray_dir[:, 0], thp=sp.thp[:, 0],
        radiance=z3, active=base_valid,
        vertex_index=(sp.vertex_index[:, 0] - 1).to(torch.int32),
        diffuse_bounces=zi, rejected_hits=zi, scene_length=z1,
        firefly_k=torch.ones_like(z1), cone_width=z1,
        cone_spread=cam.pixel_cone_spread_angle.expand(n).clone(),
        interior=sp.interior[:, 0], emissive_mis=torch.ones_like(z1),
        env_mis=torch.ones_like(z1), px=px, py=py,
        sp_branch=sp.branch_id[:, 0], sp_plane=torch.zeros_like(dom),
        sp_on_plane=base_valid, sp_on_branch=base_valid,
        sp_on_dominant=dom == 0, sp_base_diff=no, sp_base_delta=no,
        sp_gi_l=z3, sp_gi_pdf=z1, sp_gi_valid=no,
        sp_gi_thp=torch.ones_like(z3), sp_delta_only=~no,
        sp_bounces=torch.zeros_like(dom), sp_hit_t=z1,
        sp_pend_diff=z4, sp_pend_spec=z4, sp_secondary_l=z3,
        sp_committed_diff=torch.zeros((n, P, 4), dtype=torch.float32,
                                      device=dev),
        sp_committed_spec=torch.zeros((n, P, 4), dtype=torch.float32,
                                      device=dev),
        sp_plane_branch=sp.branch_id, sp_dominant=dom)


def _shade_step(assets, cfg, consts4, path, surf, shade, thp, radiance,
                origin, interior, vertex_index, nee_distant: int,
                nee_local: int, sample_base, fill_ctx):
    """One fused shade+NEE bounce step of the FILL pass: the RNG draws in
    the reference's order, K4 FILL's plain version, the batched NEE
    visibility trace, the stable-plane routing (StablePlanesHandleHit,
    StablePlanesHandleNEE), the env-pdf scatter MIS and the nested
    stack update."""
    sd = surf.sd
    nb = shade.shape[0]

    g = rng.make(path.px, path.py, vertex_index, sample_base)
    if cfg.enable_russian_roulette:
        g = rng.start_effect(g, rng.EFFECT_RUSSIAN_ROULETTE, False)
        g, u_rr = rng.next_1d(g, allow_ld=False)
    else:
        u_rr = torch.ones((nb,), dtype=torch.float32, device=shade.device)
    g = rng.start_effect(
        g, rng.EFFECT_SCATTER_BSDF,
        path.diffuse_bounces < rng.DISABLE_LD_AFTER_DIFFUSE_BOUNCES)
    g, u3 = rng.next_3d(g)

    bd = surf.bsdf_data
    # ReSTIR DI replaces the dominant plane's base NEE, so those lanes cast
    # no NEE ray
    nee_skip = path.sp_on_plane & path.sp_on_dominant
    vals = dict(
        pos=sd.pos, n=sd.n, t=sd.t, b=sd.b, face_n=sd.face_n,
        vertex_n=sd.vertex_n, v=sd.v, emission=surf.emission,
        front_facing=sd.front_facing, thin=sd.thin_surface,
        shadow_fade=sd.shadow_nol_fadeout,
        bd_diffuse=bd.diffuse, bd_specular=bd.specular,
        bd_rough=bd.roughness, bd_metallic=bd.metallic, bd_eta=bd.eta,
        bd_trans=bd.transmission, bd_dtrans=bd.diffuse_transmission,
        bd_strans=bd.specular_transmission,
        thp=thp, radiance=radiance, origin=origin,
        direction=path.direction, firefly_k=path.firefly_k,
        emissive_mis=path.emissive_mis, env_mis=path.env_mis,
        cone_spread=path.cone_spread,
        diffuse_bounces=path.diffuse_bounces, vertex_index=vertex_index,
        shade=shade, u_rr=u_rr, u3=u3, nee_skip=nee_skip)

    if nee_distant + nee_local > 0:
        g = rng.start_effect(g, rng.EFFECT_NEE, False)
    for si in range(nee_distant + nee_local):
        if si < nee_distant:
            g, ls = _sample_distant(assets, g)
            vals.update({f"ls_dir{si}": ls.direction,
                         f"ls_dist{si}": ls.distance,
                         f"ls_li{si}": ls.li, f"ls_pdf{si}": ls.pdf,
                         f"ls_valid{si}": ls.valid})
        else:
            j = si - nee_distant
            g, u3l = rng.next_3d(g, allow_ld=False)
            li_idx = LI.pick_light(assets.lights, u3l[..., 0])
            row = LI.fetch_rows(assets.lights, li_idx)
            vals.update({
                f"lrow_p0{j}": row[..., LI.LP_P0:LI.LP_P0 + 3],
                f"lrow_e1{j}": row[..., LI.LP_E1:LI.LP_E1 + 3],
                f"lrow_e2{j}": row[..., LI.LP_E2:LI.LP_E2 + 3],
                f"lrow_pos{j}": row[..., LI.LP_POS:LI.LP_POS + 3],
                f"lrow_radius{j}": row[..., LI.LP_RADIUS],
                f"lrow_rad{j}": row[..., LI.LP_RAD:LI.LP_RAD + 3],
                f"lrow_inv_area{j}": row[..., LI.LP_INV_AREA],
                f"lrow_kind{j}": row[..., LI.LP_KIND],
                f"lrow_axis{j}": row[..., LI.LP_AXIS:LI.LP_AXIS + 3],
                f"lrow_cos_cone{j}": row[..., LI.LP_COS_CONE],
                f"lrow_soft{j}": row[..., LI.LP_SOFT],
                f"pick_pdf{j}": row[..., LI.LP_POWER]
                / max(assets.lights.total_power, 1e-20),
                f"u3l{j}": u3l})

    Lin = SK.in_layout(nee_distant, nee_local)
    Lout = SK.out_layout(nee_distant, nee_local, True)
    out = SK.unpack_out(Lout, SK.shade_nee_plain(
        SK.pack_inputs(Lin, nb, vals), consts4, nee_distant=nee_distant,
        nee_local=nee_local, rr=cfg.enable_russian_roulette,
        max_bounces=cfg.max_bounces,
        max_diffuse_bounces=cfg.max_diffuse_bounces,
        spec_rough_threshold=K_SPECULAR_ROUGHNESS_THRESHOLD,
        local_pdf_k=LOCAL_PDF_ESTIMATE_K, fill=True))

    radiance = out["radiance"]
    lobe = out["lobe"].to(torch.int32)
    will_scatter = out["will_scatter"] != 0.0
    is_transmission = (lobe & B.LOBE_TRANSMISSION) != 0

    do_int = will_scatter & is_transmission & ~sd.thin_surface
    interior = torch.where(
        do_int[..., None],
        nested.handle_intersection(interior, sd.material_id,
                                   sd.nested_priority, sd.front_facing),
        interior)

    # emission routing (StablePlanesHandleHit): BUILD collected the
    # emission on the stable branch; only off-branch emission is noise
    sp_secondary_l = fill_ctx["sp_secondary_l"] + torch.where(
        (shade & ~path.sp_on_branch)[..., None], out["emission_term"], 0.0)
    sp_hit_t = torch.where(
        shade, SP.accumulate_hit_t(path.sp_hit_t, fill_ctx["hit_t"],
                                   path.sp_bounces, path.sp_delta_only),
        fill_ctx["sp_hit_t"])
    res = dict(sp_pend_diff=path.sp_pend_diff,
               sp_pend_spec=path.sp_pend_spec)

    k_total = nee_distant + nee_local
    if k_total > 0:
        needs = [out[f"nee_need{i}"] != 0.0 for i in range(k_total)]
        dists = [out[f"nee_dist{i}"] for i in range(k_total)]
        occluded = traverse.trace_anyhit(
            assets.accel, out["vis_origin"].repeat(k_total, 1),
            torch.cat([out[f"nee_dir{i}"] for i in range(k_total)], dim=0),
            t_max=torch.cat(dists, dim=0), active=torch.cat(needs, dim=0))
        visible = (~occluded).reshape(k_total, nb)
        lit = [visible[i] & needs[i] for i in range(k_total)]
        # StablePlanesHandleNEE: base-vertex NEE fills the plane's pending
        # channels, deeper vertices lump into secondaryL
        cd = cs = nee_dist = None
        for i in range(k_total):
            d_i = torch.where(lit[i][..., None], out[f"nee_contrib_d{i}"],
                              0.0)
            s_i = torch.where(lit[i][..., None], out[f"nee_contrib_s{i}"],
                              0.0)
            t_i = torch.where(lit[i], dists[i], mu.K_MAX_RAY_TRAVEL)
            cd = d_i if cd is None else cd + d_i
            cs = s_i if cs is None else cs + s_i
            nee_dist = t_i if nee_dist is None else nee_dist + t_i
        nee_dist = nee_dist / k_total
        acc_t = SP.accumulate_hit_t(sp_hit_t, nee_dist, path.sp_bounces + 1,
                                    torch.zeros_like(shade))
        on_base = (path.sp_on_plane & ~nee_skip)[..., None]
        res["sp_pend_diff"] = torch.where(
            on_base, torch.cat([cd, acc_t[..., None]], -1), path.sp_pend_diff)
        res["sp_pend_spec"] = torch.where(
            on_base, torch.cat([cs, acc_t[..., None]], -1), path.sp_pend_spec)
        sp_secondary_l = sp_secondary_l + torch.where(
            (~path.sp_on_plane)[..., None], cd + cs, 0.0)

    env_mis = out["env_mis_pre"]
    if nee_distant > 0:
        lp = EM.pdf_mip_descent(assets.env, out["direction"])
        env_w = mu.eval_mis(1.0, out["bs_pdf"], float(nee_distant), lp)
        env_mis = torch.where(out["non_delta_scatter"] != 0.0, env_w,
                              env_mis)
    # diffuse-vs-specular bounce classification (PathTracer.hlsli:196)
    rough = surf.bsdf_data.roughness
    rough_props = torch.where(rough * rough < B.K_MIN_GGX_ALPHA, 0.0, rough)
    is_reflection = (lobe & B.LOBE_REFLECTION) != 0
    res.update(
        sp_secondary_l=sp_secondary_l, sp_hit_t=sp_hit_t,
        radiance=radiance, thp=out["thp"], origin=out["origin"],
        direction=out["direction"], firefly_k=out["firefly_k"],
        cone_spread=out["cone_spread"],
        diffuse_bounces=out["diffuse_bounces"].to(torch.int32),
        interior=interior, emissive_mis=out["emissive_mis"],
        env_mis=env_mis, will_scatter=will_scatter,
        scatter_valid=out["scatter_valid"] != 0.0,
        bs_pdf=out["bs_pdf"], is_delta=(lobe & B.LOBE_DELTA) != 0,
        is_transmission=is_transmission,
        is_diffuse_bounce=is_reflection & (
            ((lobe & B.LOBE_DIFFUSE_REFLECTION) != 0)
            | (rough_props > K_SPECULAR_ROUGHNESS_THRESHOLD)))
    return res


def _on_scatter(path: PathState, ks: dict, shade, can_reject, vertex_index,
                died) -> dict:
    """StablePlanesOnScatter (PathTracerStablePlanes.hlsli:269-462): branch
    advance along delta lobes, transfer onto a plane the branch reaches,
    and commits of the pending diffuse / specular radiance into the
    current plane's channels on a transfer or when the path dies."""
    scattered = ks["will_scatter"] & ks["scatter_valid"]
    is_delta, is_trans = ks["is_delta"], ks["is_transmission"]
    was_on_plane = path.sp_on_plane & shade
    base_now = was_on_plane & scattered
    lobe_id = torch.where(is_trans, SP.LOBE_ID_TRANSMISSION,
                          SP.LOBE_ID_REFLECTION)
    vi1 = vertex_index.to(torch.int64) + 1
    can_adv = path.sp_on_branch & scattered & is_delta & \
        (vi1 <= SP.MAX_VERTEX)
    new_branch = torch.where(can_adv,
                             SP.advance_branch_id(path.sp_branch, lobe_id),
                             SP.INVALID_BRANCH)
    P = path.sp_plane_branch.shape[1]
    planes = [path.sp_plane_branch[:, p] for p in range(P)]
    onp = [SP.is_on_plane(b, new_branch) for b in planes]
    on_path = [SP.is_on_stable_path(b, new_branch, vi1) for b in planes]
    transfer_plane = sum(torch.where(onp[p], p, 0) for p in range(P))
    transfer = sum(o.to(torch.int64) for o in onp) > 0
    on_branch2 = can_adv & (sum(o.to(torch.int64) for o in on_path) > 0)

    # commits happen at a transfer onto a new plane and at path death
    do_commit = (transfer & scattered) | died
    gi_capture = path.sp_on_dominant & ~path.sp_base_delta
    sec_l = ks["sp_secondary_l"]
    hit_t = ks["sp_hit_t"]
    d4, s4 = ks["sp_pend_diff"], ks["sp_pend_spec"]
    sec = torch.where((do_commit & ~gi_capture)[..., None], sec_l, 0.0)
    d4 = torch.where((do_commit & path.sp_base_diff)[..., None],
                     SP.combine_hit_t(d4, sec, hit_t), d4)
    s4 = torch.where((do_commit & ~path.sp_base_diff)[..., None],
                     SP.combine_hit_t(s4, sec, hit_t), s4)
    gi_base = base_now & path.sp_on_dominant & ~is_delta & ~is_trans & \
        (ks["bs_pdf"] > 0.0)
    plane_oh = (torch.arange(P, device=shade.device)[None, :]
                == path.sp_plane[:, None]) & do_commit[:, None]

    def commit(chan, v4):
        add = SP.combine_hit_t(chan, v4[:, None, :3].expand(-1, P, -1),
                               v4[:, None, 3])
        return torch.where(plane_oh[..., None], add, chan)

    reset = transfer & scattered
    clear = (reset | died)[..., None]
    return dict(
        sp_branch=torch.where(scattered, new_branch, path.sp_branch),
        sp_plane=torch.where(reset, transfer_plane, path.sp_plane),
        sp_on_plane=torch.where(can_reject, path.sp_on_plane, reset),
        sp_on_branch=torch.where(scattered, on_branch2, path.sp_on_branch),
        sp_on_dominant=torch.where(reset, transfer_plane == path.sp_dominant,
                                   path.sp_on_dominant),
        sp_base_diff=torch.where(base_now, ks["is_diffuse_bounce"],
                                 path.sp_base_diff),
        sp_base_delta=torch.where(base_now, is_delta, path.sp_base_delta),
        sp_gi_l=path.sp_gi_l + torch.where(
            (do_commit & gi_capture)[..., None], sec_l, 0.0),
        sp_gi_pdf=torch.where(gi_base, ks["bs_pdf"], path.sp_gi_pdf),
        sp_gi_valid=path.sp_gi_valid | gi_base,
        sp_gi_thp=torch.where(gi_base[..., None], ks["thp"],
                              path.sp_gi_thp),
        sp_delta_only=path.sp_delta_only & (is_delta | ~scattered),
        sp_bounces=torch.where(reset, 0, path.sp_bounces
                               + scattered.to(torch.int64)),
        sp_hit_t=torch.where(reset, 0.0, hit_t),
        sp_pend_diff=torch.where(clear, 0.0, ks["sp_pend_diff"]),
        sp_pend_spec=torch.where(clear, 0.0, ks["sp_pend_spec"]),
        sp_secondary_l=torch.where(clear, 0.0, sec_l),
        sp_committed_diff=commit(path.sp_committed_diff, d4),
        sp_committed_spec=commit(path.sp_committed_spec, s4),
        sp_plane_branch=path.sp_plane_branch, sp_dominant=path.sp_dominant)


def render_fill(assets, cam, path: PathState, injected: Hit, consts, cfg):
    """The FILL bounce loop from `path` (initial_state), whose first
    iteration takes the BUILD-stored base hit `injected` instead of
    tracing. Returns dict(committed_diff, committed_spec (N,P,4), gi_l,
    gi_pdf, gi_valid, gi_thp, first = (position, oriented face normal,
    found) of the first hit after the dominant plane's base)."""
    n = path.px.shape[0]
    dev = path.px.device
    mat_iors = assets.scene.mat_ior
    vol_abs = assets.scene.volume_absorption
    nee_local = cfg.nee_local_samples if assets.lights is not None else 0
    nee_distant = cfg.nee_distant_samples
    max_iters = cfg.max_bounces + K_MAX_REJECTED_HITS + 2
    sample_base = consts.sample_base_index & rng.M32
    consts4 = torch.stack([
        torch.tensor(consts.firefly_filter_threshold, dtype=torch.float32),
        torch.tensor(consts.noisy_radiance_attenuation, dtype=torch.float32),
        torch.tensor(consts.nee_min_radiance_threshold, dtype=torch.float32),
        cam.pixel_cone_spread_angle.detach().to("cpu", torch.float32)]).to(
            dev)
    zf = lambda *s: torch.zeros((n,) + s, dtype=torch.float32, device=dev)
    first = (zf(3), zf(3), torch.zeros((n,), dtype=torch.bool, device=dev))

    def body(path, first, hit_override=None):
        if hit_override is None:
            hit = traverse.trace_closest(
                assets.accel, path.origin, path.direction,
                t_max=mu.K_MAX_RAY_TRAVEL, active=path.active)
        else:
            hit = hit_override
        is_hit = path.active & hit.valid
        is_miss = path.active & ~hit.valid

        # UpdatePathTravelled (PathTracer.hlsli:267-277)
        t_travel = torch.where(hit.valid, hit.t, mu.K_MAX_RAY_TRAVEL)
        vertex_index = path.vertex_index + path.active.to(torch.int32)
        cone_width = raycone.propagate_distance(path.cone_width,
                                                path.cone_spread, t_travel)
        scene_length = torch.clamp(path.scene_length + t_travel,
                                   max=mu.K_MAX_RAY_TRAVEL)
        path = path._replace(
            vertex_index=vertex_index,
            cone_width=torch.where(path.active, cone_width, path.cone_width),
            scene_length=torch.where(path.active, scene_length,
                                     path.scene_length))

        # HandleMiss; StablePlanesHandleMiss: BUILD collected the sky on a
        # stable branch; off-branch sky goes to secondaryL
        env_emission = path.env_mis[..., None] * EM.eval_dir(
            assets.env, path.direction)
        env_emission = mu.firefly_filter(
            env_emission, consts.firefly_filter_threshold, path.firefly_k)
        env_emission = env_emission * consts.noisy_radiance_attenuation
        env_add = torch.where(is_miss[..., None],
                              torch.clamp(path.thp * env_emission, min=0.0),
                              0.0)
        fill_ctx = dict(
            hit_t=hit.t,
            sp_secondary_l=path.sp_secondary_l + torch.where(
                (~path.sp_on_branch)[..., None], env_add, 0.0),
            sp_hit_t=torch.where(
                is_miss, SP.accumulate_hit_t(
                    path.sp_hit_t, mu.K_MAX_RAY_TRAVEL, path.sp_bounces,
                    path.sp_delta_only), path.sp_hit_t))

        # HandleHit (PathTracer.hlsli:371-525)
        surf = shading.load_surface(assets.scene, hit.prim, hit.bary,
                                    path.direction, cone_width=cone_width)
        sd = surf.sd
        # volume absorption; an injected base hit's chain absorption was
        # applied by BUILD
        in_medium = ~nested.is_empty(path.interior)
        top_mat = torch.clamp(nested.top_material(path.interior),
                              max=mat_iors.shape[0] - 1)
        absorb_t = torch.zeros_like(hit.t) if hit_override is not None \
            else hit.t
        transmittance = torch.exp(-vol_abs[top_mat] * absorb_t[..., None])
        thp = torch.where((is_hit & in_medium)[..., None],
                          path.thp * transmittance, path.thp)

        # alpha test (Sample.hlsl:408-413)
        alpha_reject = is_hit & (surf.alpha_mode == 1) & \
            (sd.opacity < surf.alpha_cutoff)
        u_blend = rng.hash32_to_float(rng.hash32_combine(
            rng.hash32_combine(rng.hash32(rng.u32(hit.prim)),
                               ((path.px << 16) & rng.M32) | path.py),
            (rng.u32(vertex_index) + rng.mul32(sample_base, 0x9E37))
            & rng.M32))
        alpha_reject = alpha_reject | (
            is_hit & (surf.alpha_mode == 2) & (u_blend >= sd.opacity))
        alpha_reject = alpha_reject | (
            is_hit & ~sd.front_facing & ~surf.double_sided)

        # nested dielectrics: reject false hits
        true_int = nested.is_true_intersection(path.interior,
                                               sd.nested_priority)
        reject = is_hit & (~true_int | alpha_reject)
        can_reject = reject & (path.rejected_hits < K_MAX_REJECTED_HITS)
        kill_reject = reject & ~can_reject
        interior = torch.where(
            (can_reject & ~alpha_reject)[..., None],
            nested.handle_intersection(path.interior, sd.material_id,
                                       sd.nested_priority, sd.front_facing),
            path.interior)
        origin = torch.where(
            can_reject[..., None],
            sd.compute_new_ray_origin(torch.zeros_like(can_reject)),
            path.origin)
        vertex_index = vertex_index - can_reject.to(torch.int32)
        rejected_hits = path.rejected_hits + can_reject.to(torch.int32)
        shade = is_hit & true_int & ~alpha_reject

        # the first hit after scattering off the dominant plane's base
        first_pos, first_nrm, first_found = first
        cap = shade & ~first_found & (path.sp_bounces == 1) & \
            path.sp_on_dominant
        first = (torch.where(cap[..., None], sd.pos, first_pos),
                 torch.where(cap[..., None],
                             torch.where(sd.front_facing[..., None],
                                         sd.face_n, -sd.face_n), first_nrm),
                 first_found | cap)

        outside_ior = nested.compute_outside_ior(
            path.interior, sd.material_id, sd.front_facing, mat_iors)
        surf = shading.update_outside_ior(surf, outside_ior)

        ks = _shade_step(assets, cfg, consts4, path, surf, shade, thp,
                         path.radiance, origin, interior, vertex_index,
                         nee_distant, nee_local, sample_base, fill_ctx)
        active = (path.active & ~is_miss & ~kill_reject) & (
            can_reject | (shade & ks["will_scatter"] & ks["scatter_valid"]))
        sp_fields = _on_scatter(path, ks, shade, can_reject, vertex_index,
                                path.active & ~active)
        new_path = PathState(
            origin=ks["origin"], direction=ks["direction"], thp=ks["thp"],
            radiance=ks["radiance"], active=active,
            vertex_index=vertex_index, diffuse_bounces=ks["diffuse_bounces"],
            rejected_hits=rejected_hits, scene_length=path.scene_length,
            firefly_k=ks["firefly_k"], cone_width=path.cone_width,
            cone_spread=ks["cone_spread"], interior=ks["interior"],
            emissive_mis=ks["emissive_mis"], env_mis=ks["env_mis"],
            px=path.px, py=path.py, **sp_fields)
        return new_path, first

    path, first = body(path, first, hit_override=injected)
    it = 1
    while it < max_iters and bool(path.active.any()):
        path, first = body(path, first)
        it += 1
    return dict(committed_diff=path.sp_committed_diff,
                committed_spec=path.sp_committed_spec, gi_l=path.sp_gi_l,
                gi_pdf=path.sp_gi_pdf, gi_valid=path.sp_gi_valid,
                gi_thp=path.sp_gi_thp, first=first)
