"""Wavefront path tracer, reference mode (counterpart of
rtxpt_tpu/pt/integrator.py; Sample.hlsl:245-330 RayGen loop, PathTracer.hlsli
HandleHit/HandleMiss, PathTracerNEE.hlsli, nested dielectrics).

Each iteration of the bounce loop runs over the whole wavefront: closest
hit trace (K1) -> env eval of misses -> surface load (K2/K3) -> alpha and
nested-dielectric rejection -> the fused shade+NEE pass (K4) -> the
batched NEE visibility trace (K1 any-hit). The reference's
`lax.while_loop` with `any(active)` as its condition is a Python loop here,
with one host sync per bounce.

spp > 1 turns on path regeneration (a lane whose sample ends starts its
pixel's next accumulation sample in place), with staged width compaction
(n -> n/2 -> n/4 -> n/8 once the live set fits) and a positional merge
back; wide single-sample wavefronts get the reference's tail compaction.
Both use the reference's stable `argsort(~active)` order, so images
match the reference's lane order.

The RNG streams are drawn in the reference's order outside the kernel, so
renders reproduce the reference's sample sequences bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..config import PTConfig, PTConstants
from ..core import mathutils as mu
from ..core import rng
from ..ops import traverse
from ..scene import envmap as EM
from ..scene import lights as LI
from ..scene.camera import CameraData, compute_rays
from ..scene.types import SceneArrays
from . import bsdf as B
from . import nested
from . import shade_kernel as SK
from . import shading
from . import visibility as VIS

K_MAX_REJECTED_HITS = 16       # PathTracer.hlsli:31
K_SPECULAR_ROUGHNESS_THRESHOLD = 0.25  # PathTracer.hlsli:29
LOCAL_PDF_ESTIMATE_K = 1.0     # PathTracerNEE.hlsli:197 (half-MIS constant)
_R2_A1 = 0.7548776662466927    # R2 jitter sequence constants
_R2_A2 = 0.5698402909980532


@dataclasses.dataclass
class RenderAssets:
    scene: SceneArrays
    env: EM.EnvMap
    lights: Optional[LI.LightTable]
    dense: object               # ops.mt_dense.DenseMT


class PathState(NamedTuple):
    """PathState SoA (PathState.hlsli:82-222)."""
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


def _map(path: PathState, fn) -> PathState:
    return PathState(*(fn(a) for a in path))


def _put(full: PathState, perm, narrow: PathState) -> PathState:
    """full with rows `perm` replaced by `narrow` (positional merge)."""
    def put(f, n):
        f = f.clone()
        f[perm] = n
        return f
    return PathState(*(put(f, n) for f, n in zip(full, narrow)))


def init_paths(cam: CameraData, px, py, cfg: PTConfig,
               consts: PTConstants, sub_sample_index: int) -> PathState:
    """EmptyPathInitialize + SetupPathPrimaryRay (PathTracer.hlsli:43-96)."""
    n = px.shape[0]
    dev = px.device
    g = rng.make(px, py, 0, (consts.sample_base_index + sub_sample_index)
                 & rng.M32)
    g, u2 = rng.next_2d(g)
    origin, direction = compute_rays(cam, px, py, u2)
    f1 = lambda v: torch.full((n,), v, dtype=torch.float32, device=dev)
    i1 = lambda: torch.zeros((n,), dtype=torch.int32, device=dev)
    return PathState(
        origin=origin, direction=direction,
        thp=torch.ones((n, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        vertex_index=i1(), diffuse_bounces=i1(), rejected_hits=i1(),
        scene_length=f1(0.0), firefly_k=f1(1.0), cone_width=f1(0.0),
        cone_spread=cam.pixel_cone_spread_angle.expand(n).clone(),
        interior=nested.empty(n, dev),
        emissive_mis=f1(1.0 if cfg.use_emissive_lights else 0.0),
        env_mis=f1(1.0 if cfg.use_env_lights else 0.0),
        px=px, py=py)


def _sample_distant(assets: RenderAssets, g):
    """GenerateEnvMapSample (PathTracerNEE.hlsli:70-108), MIP-descent
    distribution through the alias rows."""
    g, u2 = rng.next_2d(g, allow_ld=False)
    d, pdf, le = EM.sample_importance(assets.env, u2)
    li = torch.where((pdf > 0.0)[..., None],
                     le / torch.clamp(pdf, min=1e-20)[..., None], 0.0)
    return g, dict(direction=d,
                   distance=torch.full_like(pdf, mu.K_MAX_RAY_TRAVEL),
                   li=li, pdf=pdf, valid=torch.any(li > 0.0, dim=-1))


def _shade_step(assets, cfg, consts4, path, surf, shade, thp,
                radiance, origin, interior, vertex_index, s_arr, rays,
                nee_distant: int, nee_local: int, sample_base):
    """One fused shade+NEE bounce step (the reference's
    `_kernel_shade_step`): draws the RNG streams in the reference's order,
    fetches local light rows and distant env samples, runs K4, then
    applies what stays outside: the batched NEE visibility trace, the
    env-pdf scatter MIS and the nested-dielectric stack update."""
    sd = surf.sd
    nb = shade.shape[0]

    # RNG draws, reference order (sample_gen -> RR -> scatter -> NEE)
    base = sample_base if s_arr is None else \
        (sample_base + s_arr.to(torch.int64)) & rng.M32
    g = rng.make(path.px, path.py, vertex_index, base)
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
        shade=shade, u_rr=u_rr, u3=u3,
        nee_skip=torch.zeros_like(shade))

    if nee_distant + nee_local > 0:
        g = rng.start_effect(g, rng.EFFECT_NEE, False)
    for si in range(nee_distant + nee_local):
        if si < nee_distant:
            g, ls = _sample_distant(assets, g)
            vals.update({f"ls_dir{si}": ls["direction"],
                         f"ls_dist{si}": ls["distance"],
                         f"ls_li{si}": ls["li"], f"ls_pdf{si}": ls["pdf"],
                         f"ls_valid{si}": ls["valid"]})
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
    Lout = SK.out_layout(nee_distant, nee_local)
    out = SK.unpack_out(Lout, SK.shade_nee(
        SK.pack_inputs(Lin, nb, vals), consts4, nee_distant=nee_distant,
        nee_local=nee_local, rr=cfg.enable_russian_roulette,
        max_bounces=cfg.max_bounces,
        max_diffuse_bounces=cfg.max_diffuse_bounces,
        spec_rough_threshold=K_SPECULAR_ROUGHNESS_THRESHOLD,
        local_pdf_k=LOCAL_PDF_ESTIMATE_K))

    radiance = out["radiance"]
    lobe = out["lobe"].to(torch.int32)
    will_scatter = out["will_scatter"] != 0.0
    is_transmission = (lobe & B.LOBE_TRANSMISSION) != 0

    # nested stack update on transmission (integer packing stays outside)
    do_int = will_scatter & is_transmission & ~sd.thin_surface
    interior = torch.where(
        do_int[..., None],
        nested.handle_intersection(interior, sd.material_id,
                                   sd.nested_priority, sd.front_facing),
        interior)

    # batched NEE visibility trace + contribution apply
    k_total = nee_distant + nee_local
    if k_total > 0:
        needs = [out[f"nee_need{i}"] != 0.0 for i in range(k_total)]
        all_act = torch.cat(needs, dim=0)
        rays = rays + torch.stack([torch.zeros_like(rays[1]),
                                   all_act.to(torch.float32).sum()])
        occluded = VIS.trace_visibility(
            assets, out["vis_origin"].repeat(k_total, 1),
            torch.cat([out[f"nee_dir{i}"] for i in range(k_total)], dim=0),
            t_max=torch.cat([out[f"nee_dist{i}"] for i in range(k_total)],
                            dim=0),
            active=all_act)
        visible = (~occluded).reshape(k_total, nb)
        for i in range(k_total):
            radiance = radiance + torch.where(
                (visible[i] & needs[i])[..., None], out[f"nee_contrib{i}"],
                0.0)

    # scatter-side env MIS (env pdf through the alias rows, outside)
    env_mis = out["env_mis_pre"]
    if nee_distant > 0:
        lp = EM.pdf_mip_descent(assets.env, out["direction"])
        env_w = mu.eval_mis(1.0, out["bs_pdf"], float(nee_distant), lp)
        env_mis = torch.where(out["non_delta_scatter"] != 0.0, env_w,
                              env_mis)
    return dict(
        radiance=radiance, thp=out["thp"], origin=out["origin"],
        direction=out["direction"], firefly_k=out["firefly_k"],
        cone_spread=out["cone_spread"],
        diffuse_bounces=out["diffuse_bounces"].to(torch.int32),
        interior=interior, emissive_mis=out["emissive_mis"],
        env_mis=env_mis, will_scatter=will_scatter,
        scatter_valid=out["scatter_valid"] != 0.0, rays=rays)


class _Carry(NamedTuple):
    path: PathState
    it: int
    s_arr: torch.Tensor      # (N,) i32 current accumulation sample (regen)
    accum: torch.Tensor      # (N,3) finished-sample radiance sum (regen)
    rays: torch.Tensor       # (2,) [closest-hit rays, visibility rays]


def render_wavefront(assets: RenderAssets, cam: CameraData, px, py,
                     consts: PTConstants, *, cfg: PTConfig,
                     sub_sample_index: int = 0, spp: int = 1):
    """Trace sample(s) for every pixel in (px, py); returns radiance
    (N,3) — the per-pixel SUM over `spp` samples when spp > 1."""
    path0 = init_paths(cam, px, py, cfg, consts, sub_sample_index)
    return render_paths(assets, cam, path0, consts, cfg=cfg,
                        sub_sample_index=sub_sample_index, spp=spp)


def render_wavefront_counted(assets: RenderAssets, cam: CameraData, px,
                             py, consts: PTConstants, *, cfg: PTConfig,
                             sub_sample_index: int = 0, spp: int = 1):
    """render_wavefront + ray statistics: (radiance, rays) with rays =
    [closest-hit rays, visibility rays] actually cast."""
    path0 = init_paths(cam, px, py, cfg, consts, sub_sample_index)
    return render_paths(assets, cam, path0, consts, cfg=cfg,
                        sub_sample_index=sub_sample_index, spp=spp,
                        return_ray_stats=True)


def render_paths(assets: RenderAssets, cam: CameraData, path0: PathState,
                 consts: PTConstants, *, cfg: PTConfig,
                 sub_sample_index: int = 0, spp: int = 1,
                 return_ray_stats: bool = False):
    """Run the bounce loop from an initial PathState (reference mode)."""
    n = path0.px.shape[0]
    dev = path0.px.device
    mat_iors = assets.scene.mat_ior
    vol_abs = assets.scene.volume_absorption
    nee_local = cfg.nee_local_samples if assets.lights is not None else 0
    nee_distant = cfg.nee_distant_samples if cfg.use_env_lights else 0
    regen = spp > 1
    max_iters = spp * (cfg.max_bounces + 2) + K_MAX_REJECTED_HITS + 2 \
        if regen else cfg.max_bounces + K_MAX_REJECTED_HITS + 2
    sample_base = (consts.sample_base_index + sub_sample_index) & rng.M32
    consts4 = torch.stack([
        torch.tensor(consts.firefly_filter_threshold, dtype=torch.float32),
        torch.tensor(consts.noisy_radiance_attenuation, dtype=torch.float32),
        torch.tensor(consts.nee_min_radiance_threshold, dtype=torch.float32),
        cam.pixel_cone_spread_angle.detach().to("cpu", torch.float32),
    ]).to(dev)
    emissive_mis0 = 1.0 if cfg.use_emissive_lights else 0.0
    env_mis0 = 1.0 if cfg.use_env_lights else 0.0
    cam0 = cam._replace(jitter=torch.zeros_like(cam.jitter))

    def body(c: _Carry) -> _Carry:
        path, s_arr, accum = c.path, c.s_arr, c.accum
        nb = path.px.shape[0]
        rays = c.rays + torch.stack([path.active.to(torch.float32).sum(),
                                     torch.zeros_like(c.rays[0])])
        hit = traverse.trace_closest(
            assets.dense, path.origin, path.direction,
            t_max=mu.K_MAX_RAY_TRAVEL, active=path.active)
        is_hit = path.active & hit.valid
        is_miss = path.active & ~hit.valid

        # UpdatePathTravelled (PathTracer.hlsli:267-277)
        t_travel = torch.where(hit.valid, hit.t, mu.K_MAX_RAY_TRAVEL)
        vertex_index = path.vertex_index + path.active.to(torch.int32)
        cone_width = path.cone_width + path.cone_spread * t_travel
        scene_length = torch.clamp(path.scene_length + t_travel,
                                   max=mu.K_MAX_RAY_TRAVEL)
        path = path._replace(
            vertex_index=vertex_index,
            cone_width=torch.where(path.active, cone_width, path.cone_width),
            scene_length=torch.where(path.active, scene_length,
                                     path.scene_length))

        # HandleMiss (PathTracer.hlsli:287-368)
        env_emission = path.env_mis[..., None] * EM.eval_dir(
            assets.env, path.direction)
        env_emission = mu.firefly_filter(
            env_emission, consts.firefly_filter_threshold, path.firefly_k)
        env_emission = env_emission * consts.noisy_radiance_attenuation
        radiance = path.radiance + torch.where(
            is_miss[..., None], torch.clamp(path.thp * env_emission,
                                            min=0.0), 0.0)

        # HandleHit (PathTracer.hlsli:371-525)
        surf = shading.load_surface(assets.scene, hit.prim, hit.bary,
                                    path.direction)
        sd = surf.sd
        # volume absorption (Beer-Lambert; PathTracer.hlsli:406-415)
        in_medium = ~nested.is_empty(path.interior)
        top_mat = torch.clamp(nested.top_material(path.interior),
                              max=mat_iors.shape[0] - 1)
        transmittance = torch.exp(-vol_abs[top_mat] * hit.t[..., None])
        thp = torch.where((is_hit & in_medium)[..., None],
                          path.thp * transmittance, path.thp)

        # alpha test (Sample.hlsl:408-413): MASK below the cutoff and
        # stochastic BLEND transparency are rejected hits
        alpha_reject = is_hit & (surf.alpha_mode == 1) & \
            (sd.opacity < surf.alpha_cutoff)
        blend_base = sample_base if not regen else \
            (sample_base + s_arr.to(torch.int64)) & rng.M32
        u_blend = rng.hash32_to_float(rng.hash32_combine(
            rng.hash32_combine(rng.hash32(rng.u32(hit.prim)),
                               ((path.px << 16) & rng.M32) | path.py),
            (rng.u32(vertex_index) + rng.mul32(blend_base, 0x9E37))
            & rng.M32))
        alpha_reject = alpha_reject | (
            is_hit & (surf.alpha_mode == 2) & (u_blend >= sd.opacity))
        # glTF single-sided: backface hits pass through (culled)
        alpha_reject = alpha_reject | (
            is_hit & ~sd.front_facing & ~surf.double_sided)

        # nested dielectrics: reject false hits
        # (PathTracerNestedDielectrics.hlsli:48-91)
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

        outside_ior = nested.compute_outside_ior(
            path.interior, sd.material_id, sd.front_facing, mat_iors)
        surf = shading.update_outside_ior(surf, outside_ior)

        ks = _shade_step(assets, cfg, consts4, path, surf, shade,
                         thp, radiance, origin, interior, vertex_index,
                         s_arr if regen else None, rays, nee_distant,
                         nee_local, sample_base)
        active = (path.active & ~is_miss & ~kill_reject) & (
            can_reject | (shade & ks["will_scatter"] & ks["scatter_valid"]))
        new_path = PathState(
            origin=ks["origin"], direction=ks["direction"], thp=ks["thp"],
            radiance=ks["radiance"], active=active,
            vertex_index=vertex_index, diffuse_bounces=ks["diffuse_bounces"],
            rejected_hits=rejected_hits, scene_length=path.scene_length,
            firefly_k=ks["firefly_k"], cone_width=path.cone_width,
            cone_spread=ks["cone_spread"], interior=ks["interior"],
            emissive_mis=ks["emissive_mis"], env_mis=ks["env_mis"],
            px=path.px, py=path.py)
        rays = ks["rays"]

        if regen:
            # PATH REGENERATION: a finished sample's lane starts its
            # pixel's next accumulation sample immediately
            died = path.active & ~active
            accum = accum + torch.where(died[..., None], new_path.radiance,
                                        0.0)
            s_new = s_arr + died.to(torch.int32)
            do_regen = died & (s_new < spp)
            samp = (sample_base + s_new.to(torch.int64)) & rng.M32
            g0 = rng.make(path.px, path.py, 0, samp)
            g0, u2aa = rng.next_2d(g0)
            fidx = samp.to(torch.float32)
            jx = ((0.5 + _R2_A1 * fidx) % 1.0) - 0.5
            jy = ((0.5 + _R2_A2 * fidx) % 1.0) - 0.5
            o0, d0 = compute_rays(cam0, path.px.to(torch.float32) + jx,
                                  path.py.to(torch.float32) + jy, u2aa)
            m = do_regen[..., None]

            def rz(cur, v):
                return torch.where(do_regen, torch.full_like(cur, v), cur)

            new_path = new_path._replace(
                origin=torch.where(m, o0, new_path.origin),
                direction=torch.where(m, d0, new_path.direction),
                thp=torch.where(m, 1.0, new_path.thp),
                radiance=torch.where(died[..., None], 0.0,
                                     new_path.radiance),
                active=new_path.active | do_regen,
                vertex_index=rz(new_path.vertex_index, 0),
                diffuse_bounces=rz(new_path.diffuse_bounces, 0),
                rejected_hits=rz(new_path.rejected_hits, 0),
                scene_length=rz(new_path.scene_length, 0.0),
                firefly_k=rz(new_path.firefly_k, 1.0),
                cone_width=rz(new_path.cone_width, 0.0),
                cone_spread=torch.where(do_regen,
                                        cam.pixel_cone_spread_angle,
                                        new_path.cone_spread),
                interior=torch.where(m, 0, new_path.interior),
                emissive_mis=rz(new_path.emissive_mis, emissive_mis0),
                env_mis=rz(new_path.env_mis, env_mis0))
            s_arr = s_new
        return _Carry(new_path, c.it + 1, s_arr, accum, rays)

    def run(c: _Carry, stop_width=None, k_min: int = 4) -> _Carry:
        """Iterate while any lane is live and the cap is not reached; with
        stop_width, also stop once (after k_min iterations) the live set
        fits in stop_width lanes. One host sync per iteration."""
        while c.it < max_iters:
            live = int(c.path.active.sum())
            if live == 0:
                break
            if stop_width is not None and c.it >= k_min \
                    and live <= stop_width:
                break
            c = body(c)
        return c

    def narrow(c: _Carry, width: int):
        perm = torch.argsort((~c.path.active).to(torch.int8),
                             stable=True)[:width]
        return perm, _Carry(_map(c.path, lambda a: a[perm]), c.it,
                            c.s_arr[perm], c.accum[perm], c.rays)

    # morton-order the wavefront so neighbouring lanes hold spatially
    # coherent rays; the permutation is undone at the end
    perm0 = torch.argsort(mu.morton2d(path0.px, path0.py), stable=True)
    carry = _Carry(_map(path0, lambda a: a[perm0]), 0,
                   torch.zeros((n,), dtype=torch.int32, device=dev),
                   torch.zeros((n, 3), dtype=torch.float32, device=dev),
                   torch.zeros((2,), dtype=torch.float32, device=dev))
    compact = (cfg.wavefront_compaction
               and n >= cfg.wavefront_compaction_min)
    if compact and not regen:
        # tail compaction: continue the last bounces over the survivors
        n_small = max(n // 8, 1024)
        full = run(carry, stop_width=n_small)
        perm, nar = narrow(full, n_small)
        nar = run(nar)
        carry = _Carry(_put(full.path, perm, nar.path), nar.it, full.s_arr,
                       full.accum, nar.rays)
    elif compact and regen:
        # staged width compaction n -> n/2 -> n/4 -> n/8 of regen waves
        widths = []
        w = n
        while w // 2 >= max(n // 8, 1024):
            w //= 2
            widths.append(w)
        saved = []
        for w_next in widths:
            full = run(carry, stop_width=w_next)
            perm, carry = narrow(full, w_next)
            saved.append((perm, full))
        carry = run(carry)
        path, accum = carry.path, carry.accum
        for perm, full in reversed(saved):
            path = _put(full.path, perm, path)
            acc = full.accum.clone()
            acc[perm] = accum
            accum = acc
        carry = _Carry(path, carry.it, carry.s_arr, accum, carry.rays)
    else:
        carry = run(carry)

    def unperm(a):
        out = torch.empty_like(a)
        out[perm0] = a
        return out

    if regen:
        # lanes cut off by the iteration cap contribute their partial
        # sample, matching the non-regen cap behavior
        total = unperm(carry.accum + torch.where(
            carry.path.active[..., None], carry.path.radiance, 0.0))
    else:
        total = unperm(carry.path.radiance)
    return (total, carry.rays) if return_ray_stats else total
