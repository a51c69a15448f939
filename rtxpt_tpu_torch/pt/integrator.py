"""Wavefront path tracer (counterpart of rtxpt_tpu/pt/integrator.py;
Sample.hlsl:245-330 RayGen loop, PathTracer.hlsli HandleHit/HandleMiss,
PathTracerNEE.hlsli, nested dielectrics, PathTracerStablePlanes.hlsli FILL).

Each iteration of the bounce loop runs over the whole wavefront: closest
hit trace (ops/traverse.py: K1, or K5/K6 on the BVH tiers) -> env eval of
misses -> surface load (K2/K3) -> alpha and nested-dielectric rejection ->
the fused shade+NEE pass (K4) -> the batched NEE visibility trace (any-hit
through the same dispatch). The reference's
`lax.while_loop` with `any(active)` as its condition is a Python loop here,
with one host sync per bounce.

spp > 1 turns on path regeneration (a lane whose sample ends starts its
pixel's next accumulation sample in place), with staged width compaction
(n -> n/2 -> n/4 -> n/8 once the live set fits) and a positional merge
back; wide single-sample wavefronts get the reference's tail compaction.
Both use the reference's stable `argsort(~active)` order, so images
match the reference's lane order. cfg.wavefront_sort other than "none"
instead re-sorts the wavefront after each bounce by the reference's key
(`wavefront_sort_key`); the per-lane math is the same, so the image is
too.

The RNG streams are drawn in the reference's order outside the kernel, so
renders reproduce the reference's sample sequences bit for bit.

In the realtime mode's FILL pass (cfg.mode == MODE_FILL_STABLE_PLANES and a
PathState carrying the sp_* fields) the loop resumes from the BUILD pass's
plane-0 base hit (`injected_hit`), runs K4's FILL variant, and routes
emission, NEE and secondary radiance into per-plane diffuse / specular
channels (StablePlanesHandleHit / HandleMiss / HandleNEE / OnScatter);
`capture_first_hit` exports the secondary surface ReSTIR GI reuses.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..config import MODE_FILL_STABLE_PLANES, PTConfig, PTConstants
from ..core import mathutils as mu
from ..core import rng
from ..ops import mt_dense, traverse
from ..scene import envmap as EM
from ..scene import lights as LI
from ..scene.camera import CameraData, compute_rays
from ..scene.types import SceneArrays
from . import bsdf as B
from . import nested
from . import shade_kernel as SK
from . import shading
from . import stableplanes as SP
from . import visibility as VIS

K_MAX_REJECTED_HITS = 16       # PathTracer.hlsli:31
K_SPECULAR_ROUGHNESS_THRESHOLD = 0.25  # PathTracer.hlsli:29
LOCAL_PDF_ESTIMATE_K = 1.0     # PathTracerNEE.hlsli:197 (half-MIS constant)
_R2_A1 = 0.7548776662466927    # R2 jitter sequence constants
_R2_A2 = 0.5698402909980532
SORT_MODES = ("none", "octant", "material", "raystream")
_SORT_LAST = 1 << 30           # key of the lanes a sort puts last


@dataclasses.dataclass
class RenderAssets:
    scene: SceneArrays
    env: EM.EnvMap
    lights: Optional[LI.LightTable]
    accel: object   # ops.mt_dense.DenseMT / ops.bvh.BVH8 / ops.bvh2l.BVH8TwoLevel


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
    # ---- stable-planes FILL state (None outside the FILL pass) ----------
    sp_branch: torch.Tensor = None       # (N,) stableBranchID (u32 in i64)
    sp_plane: torch.Tensor = None        # (N,) i64 current plane index
    sp_on_plane: torch.Tensor = None     # (N,) bool
    sp_on_branch: torch.Tensor = None    # (N,) bool
    sp_on_dominant: torch.Tensor = None  # (N,) bool
    sp_base_diff: torch.Tensor = None    # (N,) bool base scatter diffuse
    sp_base_delta: torch.Tensor = None   # (N,) bool base scatter delta
    sp_gi_l: torch.Tensor = None         # (N,3) secondary L for ReSTIR GI
    sp_gi_pdf: torch.Tensor = None       # (N,) base scatter pdf
    sp_gi_valid: torch.Tensor = None     # (N,) bool GI-eligible base
    sp_gi_thp: torch.Tensor = None       # (N,3) throughput after the base
    #   scatter; gi_l / sp_gi_thp = Lo(secondary -> base)
    sp_delta_only: torch.Tensor = None   # (N,) bool delta-only since plane
    sp_bounces: torch.Tensor = None      # (N,) i64 bounces from the plane
    sp_hit_t: torch.Tensor = None        # (N,) accumulated sample hitT
    sp_pend_diff: torch.Tensor = None    # (N,4) pending diff radiance+hitT
    sp_pend_spec: torch.Tensor = None    # (N,4)
    sp_secondary_l: torch.Tensor = None  # (N,3)
    sp_committed_diff: torch.Tensor = None  # (N,P,4) per-plane channels
    sp_committed_spec: torch.Tensor = None  # (N,P,4)
    sp_plane_branch: torch.Tensor = None    # (N,P) plane branch ids
    sp_dominant: torch.Tensor = None        # (N,) i64 dominant plane


def _map(path: PathState, fn) -> PathState:
    return PathState(*(None if a is None else fn(a) for a in path))


def _put_rows(full, perm, narrow):
    """full with rows `perm` replaced by `narrow` (positional merge)."""
    out = full.clone()
    out[perm] = narrow
    return out


def _put(full: PathState, perm, narrow: PathState) -> PathState:
    return PathState(*(None if f is None else _put_rows(f, perm, n)
                       for f, n in zip(full, narrow)))


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
                nee_distant: int, nee_local: int, sample_base,
                fill_ctx=None):
    """One fused shade+NEE bounce step (the reference's
    `_kernel_shade_step`): draws the RNG streams in the reference's order,
    fetches local light rows and distant env samples, runs K4, then
    applies what stays outside: the batched NEE visibility trace, the
    env-pdf scatter MIS and the nested-dielectric stack update.

    fill_ctx: None, or for a FILL wavefront {hit_t, sp_secondary_l,
    sp_hit_t}; K4's FILL variant then exports the emission term and the
    split NEE, and the stable-plane routing (StablePlanesHandleHit,
    StablePlanesHandleNEE) happens here."""
    sd = surf.sd
    nb = shade.shape[0]
    fill = fill_ctx is not None

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
        # FILL: ReSTIR DI replaces the dominant plane's base NEE, so those
        # lanes cast no NEE ray
        nee_skip=(path.sp_on_plane & path.sp_on_dominant
                  if fill and cfg.use_restir_di else torch.zeros_like(shade)))

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
    Lout = SK.out_layout(nee_distant, nee_local, fill)
    kernel = SK.shade_nee_fill if fill else SK.shade_nee
    out = SK.unpack_out(Lout, kernel(
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

    res = {}
    if fill:
        # emission routing (StablePlanesHandleHit): BUILD collected the
        # emission on the stable branch; only off-branch emission is noise
        sp_secondary_l = fill_ctx["sp_secondary_l"] + torch.where(
            (shade & ~path.sp_on_branch)[..., None], out["emission_term"],
            0.0)
        sp_hit_t = torch.where(
            shade, SP.accumulate_hit_t(path.sp_hit_t, fill_ctx["hit_t"],
                                       path.sp_bounces, path.sp_delta_only),
            fill_ctx["sp_hit_t"])
        res["sp_pend_diff"] = path.sp_pend_diff
        res["sp_pend_spec"] = path.sp_pend_spec

    # batched NEE visibility trace + contribution apply
    k_total = nee_distant + nee_local
    if k_total > 0:
        needs = [out[f"nee_need{i}"] != 0.0 for i in range(k_total)]
        dists = [out[f"nee_dist{i}"] for i in range(k_total)]
        all_act = torch.cat(needs, dim=0)
        rays = rays + torch.stack([torch.zeros_like(rays[1]),
                                   all_act.to(torch.float32).sum()])
        occluded = VIS.trace_visibility(
            assets, out["vis_origin"].repeat(k_total, 1),
            torch.cat([out[f"nee_dir{i}"] for i in range(k_total)], dim=0),
            t_max=torch.cat(dists, dim=0), active=all_act)
        visible = (~occluded).reshape(k_total, nb)
        lit = [visible[i] & needs[i] for i in range(k_total)]
        if fill:
            # StablePlanesHandleNEE: base-vertex NEE fills the plane's
            # pending channels, deeper vertices lump into secondaryL
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
            restir_covered = path.sp_on_plane & path.sp_on_dominant \
                if cfg.use_restir_di else torch.zeros_like(shade)
            acc_t = SP.accumulate_hit_t(sp_hit_t, nee_dist,
                                        path.sp_bounces + 1,
                                        torch.zeros_like(shade))
            on_base = (path.sp_on_plane & ~restir_covered)[..., None]
            res["sp_pend_diff"] = torch.where(
                on_base, torch.cat([cd, acc_t[..., None]], -1),
                path.sp_pend_diff)
            res["sp_pend_spec"] = torch.where(
                on_base, torch.cat([cs, acc_t[..., None]], -1),
                path.sp_pend_spec)
            sp_secondary_l = sp_secondary_l + torch.where(
                (~path.sp_on_plane)[..., None], cd + cs, 0.0)
        else:
            for i in range(k_total):
                radiance = radiance + torch.where(
                    lit[i][..., None], out[f"nee_contrib{i}"], 0.0)

    # scatter-side env MIS (env pdf through the alias rows, outside)
    env_mis = out["env_mis_pre"]
    if nee_distant > 0:
        lp = EM.pdf_mip_descent(assets.env, out["direction"])
        env_w = mu.eval_mis(1.0, out["bs_pdf"], float(nee_distant), lp)
        env_mis = torch.where(out["non_delta_scatter"] != 0.0, env_w,
                              env_mis)
    if fill:
        res["sp_secondary_l"] = sp_secondary_l
        res["sp_hit_t"] = sp_hit_t
    # diffuse-vs-specular bounce classification (PathTracer.hlsli:196)
    rough = surf.bsdf_data.roughness
    rough_props = torch.where(rough * rough < B.K_MIN_GGX_ALPHA, 0.0, rough)
    is_reflection = (lobe & B.LOBE_REFLECTION) != 0
    res.update(
        radiance=radiance, thp=out["thp"], origin=out["origin"],
        direction=out["direction"], firefly_k=out["firefly_k"],
        cone_spread=out["cone_spread"],
        diffuse_bounces=out["diffuse_bounces"].to(torch.int32),
        interior=interior, emissive_mis=out["emissive_mis"],
        env_mis=env_mis, will_scatter=will_scatter,
        scatter_valid=out["scatter_valid"] != 0.0, rays=rays,
        bs_pdf=out["bs_pdf"], is_delta=(lobe & B.LOBE_DELTA) != 0,
        is_transmission=is_transmission,
        is_diffuse_bounce=is_reflection & (
            ((lobe & B.LOBE_DIFFUSE_REFLECTION) != 0)
            | (rough_props > K_SPECULAR_ROUGHNESS_THRESHOLD)))
    return res


def sort_bounds(assets: RenderAssets):
    """(lo, hi) (3,) world bounds in which the raystream key quantizes ray
    origins: the dense cluster boxes', or the triangle soup's (p0, p0 +
    e1, p0 + e2) on the BVH tiers, as the reference computes them."""
    accel = assets.accel
    if isinstance(accel, mt_dense.DenseMT):
        return accel.aabb[:, 0:3].amin(0), accel.aabb[:, 3:6].amax(0)
    p, i = assets.scene.positions, assets.scene.indices.long()
    p0 = p[i[:, 0]]
    p1, p2 = p0 + (p[i[:, 1]] - p0), p0 + (p[i[:, 2]] - p0)
    return (torch.minimum(p0, torch.minimum(p1, p2)).amin(0),
            torch.maximum(p0, torch.maximum(p1, p2)).amax(0))


def _octant(d):
    return ((d[..., 0] < 0).to(torch.int64) + 2 * (d[..., 1] < 0).to(
        torch.int64) + 4 * (d[..., 2] < 0).to(torch.int64))


def wavefront_sort_key(mode: str, active, direction, material_id,
                       new_path: PathState, bounds=None):
    """The reference's per-bounce sort key (rtxpt_tpu/pt/integrator.py
    :1053-1110), int64 (N,). `active`, `direction` and `material_id` are
    the bounce's own (before path regeneration), `new_path` the state the
    next bounce starts from; `bounds` = sort_bounds() for "raystream".

    "octant": the scatter direction's octant, inactive lanes last;
    "raystream": morton3d of the new ray origin's cell in a 32^3 grid over
    `bounds`, times 8, plus the new direction's octant, inactive lanes
    last; "material": the shaded material id, inactive lanes last."""
    if mode == "octant":
        return torch.where(active, _octant(direction), 8)
    if mode == "raystream":
        lo, hi = bounds
        scale = 31.999 / torch.clamp(hi - lo, min=1e-6)
        q = torch.clamp((new_path.origin - lo) * scale, 0.0, 31.999).to(
            torch.int64)
        key = mu.morton3d(q[..., 0], q[..., 1], q[..., 2]) * 8 \
            + _octant(new_path.direction)
        return torch.where(new_path.active, key, _SORT_LAST)
    if mode == "material":
        return torch.where(active, material_id.to(torch.int64), _SORT_LAST)
    raise ValueError(f"wavefront_sort {mode!r} is not one of {SORT_MODES}")


class _Carry(NamedTuple):
    path: PathState
    it: int
    s_arr: torch.Tensor      # (N,) i32 current accumulation sample (regen)
    accum: torch.Tensor      # (N,3) finished-sample radiance sum (regen)
    rays: torch.Tensor       # (2,) [closest-hit rays, visibility rays]
    first: tuple             # (pos (N,3), normal (N,3), found (N,)) of the
    #                          first true hit (capture_first_hit)
    lane0: torch.Tensor      # (N,) original lane of each position


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
                 return_ray_stats: bool = False,
                 capture_first_hit: bool = False, injected_hit=None):
    """Run the bounce loop from an initial PathState.

    FILL pass (cfg.mode == MODE_FILL_STABLE_PLANES, sp_* fields set):
    `injected_hit` is the BUILD pass's stored base hit, which the first
    iteration uses instead of tracing; returns a dict of the per-plane
    channels (committed_diff, committed_spec), the ReSTIR GI inputs
    (gi_l, gi_pdf, gi_valid, gi_thp), ray_stats and, with
    capture_first_hit, `first` = (position, oriented face normal, found)
    of the first hit after the dominant plane's base (the secondary
    surface of Sample.hlsl:279)."""
    n = path0.px.shape[0]
    dev = path0.px.device
    mat_iors = assets.scene.mat_ior
    vol_abs = assets.scene.volume_absorption
    nee_local = cfg.nee_local_samples if assets.lights is not None else 0
    nee_distant = cfg.nee_distant_samples if cfg.use_env_lights else 0
    fill = cfg.mode == MODE_FILL_STABLE_PLANES and path0.sp_branch is not None
    regen = spp > 1
    sort = cfg.wavefront_sort
    if sort not in SORT_MODES:
        raise ValueError(f"wavefront_sort {sort!r} is not one of {SORT_MODES}")
    bounds = sort_bounds(assets) if sort == "raystream" else None
    if regen and (fill or capture_first_hit or injected_hit is not None):
        raise ValueError("path regeneration serves plain reference renders")
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

    def body(c: _Carry, hit_override=None) -> _Carry:
        path, s_arr, accum = c.path, c.s_arr, c.accum
        nb = path.px.shape[0]
        if hit_override is None:
            rays = c.rays + torch.stack([path.active.to(torch.float32).sum(),
                                         torch.zeros_like(c.rays[0])])
            hit = traverse.trace_closest(
                assets.accel, path.origin, path.direction,
                t_max=mu.K_MAX_RAY_TRAVEL, active=path.active)
        else:
            rays, hit = c.rays, hit_override
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
        env_add = torch.where(is_miss[..., None],
                              torch.clamp(path.thp * env_emission, min=0.0),
                              0.0)
        fill_ctx = None
        if fill:
            # StablePlanesHandleMiss: BUILD collected the sky on a stable
            # branch; off-branch sky goes to secondaryL
            radiance = path.radiance
            fill_ctx = dict(
                hit_t=hit.t,
                sp_secondary_l=path.sp_secondary_l + torch.where(
                    (~path.sp_on_branch)[..., None], env_add, 0.0),
                sp_hit_t=torch.where(
                    is_miss, SP.accumulate_hit_t(
                        path.sp_hit_t, mu.K_MAX_RAY_TRAVEL, path.sp_bounces,
                        path.sp_delta_only), path.sp_hit_t))
        else:
            radiance = path.radiance + env_add

        # HandleHit (PathTracer.hlsli:371-525)
        surf = shading.load_surface(assets.scene, hit.prim, hit.bary,
                                    path.direction)
        sd = surf.sd
        # volume absorption (Beer-Lambert; PathTracer.hlsli:406-415); an
        # injected base hit's chain absorption was applied by BUILD
        in_medium = ~nested.is_empty(path.interior)
        top_mat = torch.clamp(nested.top_material(path.interior),
                              max=mat_iors.shape[0] - 1)
        absorb_t = torch.zeros_like(hit.t) if hit_override is not None \
            else hit.t
        transmittance = torch.exp(-vol_abs[top_mat] * absorb_t[..., None])
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

        # first true hit (the secondary surface ReSTIR GI reuses); in FILL
        # the first hit after scattering off the dominant plane's base
        first_pos, first_nrm, first_found = c.first
        cap = shade & ~first_found
        if fill:
            cap = cap & (path.sp_bounces == 1) & path.sp_on_dominant
        first = (torch.where(cap[..., None], sd.pos, first_pos),
                 torch.where(cap[..., None],
                             torch.where(sd.front_facing[..., None],
                                         sd.face_n, -sd.face_n), first_nrm),
                 first_found | cap)

        outside_ior = nested.compute_outside_ior(
            path.interior, sd.material_id, sd.front_facing, mat_iors)
        surf = shading.update_outside_ior(surf, outside_ior)

        ks = _shade_step(assets, cfg, consts4, path, surf, shade,
                         thp, radiance, origin, interior, vertex_index,
                         s_arr if regen else None, rays, nee_distant,
                         nee_local, sample_base, fill_ctx)
        active = (path.active & ~is_miss & ~kill_reject) & (
            can_reject | (shade & ks["will_scatter"] & ks["scatter_valid"]))
        sp_fields = {}
        if fill:
            sp_fields = _on_scatter(cfg, path, ks, shade, can_reject,
                                    vertex_index, path.active & ~active)
        new_path = PathState(
            origin=ks["origin"], direction=ks["direction"], thp=ks["thp"],
            radiance=ks["radiance"], active=active,
            vertex_index=vertex_index, diffuse_bounces=ks["diffuse_bounces"],
            rejected_hits=rejected_hits, scene_length=path.scene_length,
            firefly_k=ks["firefly_k"], cone_width=path.cone_width,
            cone_spread=ks["cone_spread"], interior=ks["interior"],
            emissive_mis=ks["emissive_mis"], env_mis=ks["env_mis"],
            px=path.px, py=path.py, **sp_fields)
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
        lane0 = c.lane0
        if sort != "none":
            perm = torch.argsort(wavefront_sort_key(
                sort, active, ks["direction"], sd.material_id, new_path,
                bounds), stable=True)
            new_path = _map(new_path, lambda a: a[perm])
            first = tuple(a[perm] for a in first)
            lane0 = lane0[perm]
            if regen:
                s_arr, accum = s_arr[perm], accum[perm]
        return _Carry(new_path, c.it + 1, s_arr, accum, rays, first, lane0)

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
                            c.s_arr[perm], c.accum[perm], c.rays,
                            tuple(a[perm] for a in c.first), c.lane0[perm])

    def merge(full: _Carry, perm, nar: _Carry) -> _Carry:
        """The narrow carry's lanes written back into the full one (the
        narrow loop never re-sorts: compaction runs only under "none")."""
        return _Carry(_put(full.path, perm, nar.path), nar.it, full.s_arr,
                      _put_rows(full.accum, perm, nar.accum), nar.rays,
                      tuple(_put_rows(f, perm, a)
                            for f, a in zip(full.first, nar.first)),
                      full.lane0)

    # morton-order the wavefront so neighbouring lanes hold spatially
    # coherent rays; the permutation (and any re-sort) is undone at the end
    perm0 = torch.argsort(mu.morton2d(path0.px, path0.py), stable=True)
    zf = lambda *shape: torch.zeros((n,) + shape, dtype=torch.float32,
                                    device=dev)
    carry = _Carry(_map(path0, lambda a: a[perm0]), 0,
                   torch.zeros((n,), dtype=torch.int32, device=dev),
                   zf(3), torch.zeros((2,), dtype=torch.float32, device=dev),
                   (zf(3), zf(3),
                    torch.zeros((n,), dtype=torch.bool, device=dev)), perm0)
    if injected_hit is not None:
        # FILL resumes from the BUILD-stored plane-0 base hit without
        # re-tracing the camera -> base chain (firstHitFromBasePlane,
        # Sample.hlsl:67): the first iteration takes the stored hit
        carry = body(carry, hit_override=type(injected_hit)(
            *(a[perm0] for a in injected_hit)))
    compact = (cfg.wavefront_compaction and sort == "none"
               and n >= cfg.wavefront_compaction_min)
    if compact and not regen:
        # tail compaction: continue the last bounces over the survivors
        n_small = max(n // 8, 1024)
        full = run(carry, stop_width=n_small)
        perm, nar = narrow(full, n_small)
        carry = merge(full, perm, run(nar))
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
        for perm, full in reversed(saved):
            carry = merge(full, perm, carry)
    else:
        carry = run(carry)

    def unperm(a):
        out = torch.empty_like(a)
        out[carry.lane0] = a
        return out

    path = carry.path
    if regen:
        # lanes cut off by the iteration cap contribute their partial
        # sample, matching the non-regen cap behavior
        total = unperm(carry.accum + torch.where(
            path.active[..., None], path.radiance, 0.0))
    else:
        total = unperm(path.radiance)
    first = tuple(unperm(a) for a in carry.first)
    if fill:
        out = dict(committed_diff=unperm(path.sp_committed_diff),
                   committed_spec=unperm(path.sp_committed_spec),
                   gi_l=unperm(path.sp_gi_l), gi_pdf=unperm(path.sp_gi_pdf),
                   gi_valid=unperm(path.sp_gi_valid),
                   gi_thp=unperm(path.sp_gi_thp), ray_stats=carry.rays)
        if capture_first_hit:
            out["first"] = first
        return out
    out = (total, first) if capture_first_hit else (total,)
    if return_ray_stats:
        out = out + (carry.rays,)
    return out[0] if len(out) == 1 else out


def _on_scatter(cfg: PTConfig, path: PathState, ks: dict, shade,
                can_reject, vertex_index, died) -> dict:
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
    gi_capture = path.sp_on_dominant & ~path.sp_base_delta \
        if cfg.use_restir_gi else torch.zeros_like(shade)
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
