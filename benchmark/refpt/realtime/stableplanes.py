"""Stable-planes BUILD (counterpart of the port's pt/stableplanes.py;
PathTracerStablePlanes.hlsli BUILD :95-246): the per-pixel delta-tree walk
that stores up to P planes, and the branch-id and hitT helpers FILL uses.
The walk runs over every lane to its end (the port narrows the wavefront
once the walkers fit in n // 8 lanes: lanes move, their arithmetic does
not)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import mathutils as mu
from ..ops import traverse
from ..pt import bsdf as B
from ..pt import nested
from ..pt import shading
from ..scene import envmap as EM
from ..scene.camera import compute_rays
from .extra import make_wavefront_bsdf, project_to_screen, reflect

M32 = 0xFFFFFFFF
INVALID_BRANCH = 0xFFFFFFFF
ROOT_BRANCH = 1
MAX_VERTEX = 15                  # cStablePlaneMaxVertexIndex
# delta lobe ids (the reference's evalDeltaLobes order; 2 bits a vertex)
LOBE_ID_TRANSMISSION = 0
LOBE_ID_REFLECTION = 1

K_DELTA_IGNORE = 0.001           # deltaIgnoreThreshold
K_NON_DELTA_IGNORE = 1e-5        # nonDeltaIgnoreThreshold


def advance_branch_id(branch_id, lobe_id):
    """StablePlanesAdvanceBranchID (StablePlanes.hlsli:300)."""
    return ((branch_id << 2) | lobe_id) & M32


def branch_vertex_index(branch_id):
    """StablePlanesVertexIndexFromBranchID: firstbithigh(id) / 2 + 1."""
    safe = torch.clamp(branch_id, min=1).to(torch.float64)
    high = torch.frexp(safe).exponent.to(torch.int64) - 1
    return high // 2 + 1


def is_on_plane(plane_branch, vertex_branch):
    return (plane_branch == vertex_branch) & (plane_branch != INVALID_BRANCH)


def is_on_stable_path(plane_branch, vertex_branch, vertex_index):
    """Prefix test (StablePlanes.hlsli:323-328)."""
    pvi = branch_vertex_index(plane_branch)
    shift = torch.clamp(pvi - vertex_index, min=0) * 2
    ok = (plane_branch >> shift) == vertex_branch
    return ok & (vertex_index <= pvi) & (plane_branch != INVALID_BRANCH)


def accumulate_hit_t(current, segment_t, bounces_from_plane, delta_only):
    """StablePlaneAccumulateSampleHitT (StablePlanes.hlsli:339-349): the
    first bounce from the plane records hitT, one glass-like entry/exit
    pair passes through, later bounces keep the value."""
    return torch.where(
        bounces_from_plane == 1, segment_t,
        torch.where((bounces_from_plane > 1) & (bounces_from_plane <= 3)
                    & delta_only, current + segment_t, current))


def combine_hit_t(cur4, new3, new_t):
    """StablePlaneCombineWithHitTCompensation: radiance sums, hitT blends
    by luminance weight."""
    lc = mu.luminance(cur4[..., :3])
    ln = mu.luminance(new3)
    tot = lc + ln
    t = torch.where(tot > 1e-9,
                    (cur4[..., 3] * lc + new_t * ln) / torch.clamp(tot,
                                                                 min=1e-9),
                    torch.maximum(cur4[..., 3], new_t))
    return torch.cat([cur4[..., :3] + new3, t[..., None]], -1)


class StablePlanes(NamedTuple):
    """Per-pixel plane SoA; every array is (N, P) or (N, P, C)."""
    branch_id: torch.Tensor       # (N,P) uint32 in i64; INVALID = empty
    vertex_index: torch.Tensor    # (N,P) i64
    prim: torch.Tensor            # (N,P) i32 base hit (-1 = sky plane)
    bary: torch.Tensor            # (N,P,2)
    ray_dir: torch.Tensor         # (N,P,3) incoming dir at the base
    scene_length: torch.Tensor    # (N,P)
    thp: torch.Tensor             # (N,P,3) throughput camera -> base
    interior: torch.Tensor        # (N,P,2) nested stack at the base
    normal: torch.Tensor          # (N,P,3) denoiser guide
    roughness: torch.Tensor       # (N,P)
    diff_est: torch.Tensor        # (N,P,3) thp-weighted diffuse estimate
    spec_est: torch.Tensor        # (N,P,3)
    view_z: torch.Tensor          # (N,P) linear depth
    motion: torch.Tensor          # (N,P,2) screen-space motion (px)
    pos: torch.Tensor             # (N,P,3) base world position
    dominant: torch.Tensor        # (N,) i64 dominant plane index
    first_hit_t: torch.Tensor     # (N,)
    stable_radiance: torch.Tensor  # (N,3) emission along the delta tree

    @property
    def count(self) -> int:
        return self.branch_id.shape[1]


def _delta_lobes(surf, bsdf):
    """The delta lobes of the standard BSDF (evalDeltaLobes): (refl_dir,
    refl_thp, trans_dir, trans_thp, non-delta mass). Thin surfaces
    transmit straight through; a smooth dielectric reflects through the
    Fresnel term of its transmission lobe."""
    sd = surf.sd
    n = sd.n
    vec = lambda t: torch.stack(t, -1)
    cos_i = torch.sum(sd.v * n, -1)
    f, cos_t = B.fresnel_dielectric(bsdf["eta"], cos_i)
    is_delta_t = (bsdf["alpha_t"] == 0.0) & (bsdf["p_specular_t"] > 0.0)
    is_delta_r = ((bsdf["alpha"] == 0.0) & (bsdf["p_specular"] > 0.0)) \
        | is_delta_t
    refl_dir = reflect(-sd.v, n)
    refr_dir = mu.safe_normalize(
        (bsdf["eta"] * cos_i - cos_t)[..., None] * n
        - bsdf["eta"][..., None] * sd.v)
    trans_dir = torch.where(sd.thin_surface[..., None], -sd.v, refr_dir)
    is_metal = bsdf["p_specular"] > bsdf["p_specular_t"]
    metal_w = vec(B.fresnel_schlick3(bsdf["spec_albedo"], 1.0, cos_i))
    refl_thp = torch.where(is_metal[..., None], metal_w,
                           f[..., None] * torch.ones_like(metal_w))
    refl_thp = torch.where(is_delta_r[..., None], refl_thp, 0.0)
    trans_thp = torch.where(is_delta_t[..., None],
                            (1.0 - f)[..., None] * vec(bsdf["trans_albedo"]),
                            0.0)
    non_delta = bsdf["p_diffuse"] + bsdf["p_diffuse_t"] \
        + torch.where(bsdf["alpha"] > 0.0, bsdf["p_specular"], 0.0) \
        + torch.where(bsdf["alpha_t"] > 0.0, bsdf["p_specular_t"], 0.0)
    return refl_dir, refl_thp, trans_dir, trans_thp, non_delta


def _bsdf_estimates(surf):
    """estimateSpecDiffBSDF guide albedos (StandardBSDF.hlsli:116-121)."""
    d = surf.bsdf_data
    dt = d.diffuse_transmission[..., None]
    st = d.specular_transmission[..., None]
    diff = (1.0 - dt) * (1.0 - st) * d.diffuse
    spec = (1.0 - st) * d.specular + st * d.transmission
    return diff, spec


# names of the per-lane BUILD state; "sp_*" are the StablePlanes fields
_SP_FIELDS = StablePlanes._fields


def build_stable_planes(assets, cam, prev_cam,
                        px, py, *, plane_count: int = 3,
                        max_vertex_depth: int = 6) -> StablePlanes:
    """BUILD pass: per-pixel delta-tree walk storing up to plane_count
    stable vertices (PathTracerStablePlanes.hlsli:95-246). The state of
    the walk is one dict of per-lane tensors (walk, queue and plane
    arrays), updated in place."""
    n = px.shape[0]
    dev = px.device
    P = plane_count
    origin0, dir0 = compute_rays(cam, px, py)
    f32, i64 = torch.float32, torch.int64
    z = lambda *shape: torch.zeros((n,) + shape, dtype=f32, device=dev)
    full = lambda shape, v, dt: torch.full((n,) + shape, v, dtype=dt,
                                           device=dev)

    s = dict(
        # pending-branch queue, slot p: ray and path state to explore
        q_origin=z(P, 3), q_dir=z(P, 3), q_thp=z(P, 3),
        q_branch=full((P,), INVALID_BRANCH, i64),
        q_interior=torch.zeros((n, P, 2), dtype=i64, device=dev),
        q_scene_len=z(P), q_vertex=full((P,), 0, i64),
        q_valid=full((P,), False, torch.bool),
        next_free=full((), 1, i64),          # slot 0 occupied
        cur_xy=torch.stack([px.to(f32), py.to(f32)], -1),
        # plane outputs
        sp_branch_id=full((P,), INVALID_BRANCH, i64),
        sp_vertex_index=full((P,), 0, i64),
        sp_prim=full((P,), -1, torch.int32),
        sp_bary=z(P, 2), sp_ray_dir=z(P, 3), sp_scene_length=z(P),
        sp_thp=z(P, 3),
        sp_interior=torch.zeros((n, P, 2), dtype=i64, device=dev),
        sp_normal=z(P, 3), sp_roughness=z(P), sp_diff_est=z(P, 3),
        sp_spec_est=z(P, 3), sp_view_z=full((P,), mu.K_MAX_RAY_TRAVEL, f32),
        sp_motion=z(P, 2), sp_pos=z(P, 3),
        sp_dominant=full((), 0, i64),
        sp_first_hit_t=full((), mu.K_MAX_RAY_TRAVEL, f32),
        sp_stable_radiance=z(3))
    s["q_origin"][:, 0] = origin0
    s["q_dir"][:, 0] = dir0
    s["q_thp"][:, 0] = 1.0
    s["q_branch"][:, 0] = ROOT_BRANCH
    s["q_valid"][:, 0] = True

    mat_last = assets.scene.mat_ior.shape[0] - 1
    big = mu.K_MAX_RAY_TRAVEL

    def store_plane(s, slot, lanes, branch, vertex, prim, bary, ray_dir,
                    scene_len, thp, interior, normal, rough, diff_e, spec_e,
                    pos, is_sky):
        """Masked write of plane `slot` for `lanes`."""
        def upd(name, val):
            arr = s["sp_" + name]
            m = lanes if arr.dim() == 2 else lanes[:, None]
            arr[:, slot] = torch.where(m, val, arr[:, slot])

        upd("branch_id", branch)
        upd("vertex_index", vertex)
        upd("prim", torch.where(is_sky, -1, prim))
        upd("bary", bary)
        upd("ray_dir", ray_dir)
        upd("scene_length", scene_len)
        upd("thp", thp)
        upd("interior", interior)
        upd("normal", normal)
        upd("roughness", rough)
        upd("diff_est", torch.clamp(diff_e * thp, 0.04, 6.5e4))
        upd("spec_est", torch.clamp(spec_e * thp, 0.04, 6.5e4))
        # motion and view_z from the base world position (sky: max depth,
        # motion from the rotation-only reprojection of the direction)
        cur_xy = s["cur_xy"]
        prev_xy, _ = project_to_screen(prev_cam, pos)
        _, view_z = project_to_screen(cam, pos)
        sky_xy, _ = project_to_screen(prev_cam._replace(pos=cam.pos), pos)
        motion = torch.where(is_sky[:, None], sky_xy - cur_xy,
                             prev_xy - cur_xy)
        upd("view_z", torch.where(is_sky, big, view_z))
        upd("motion", motion)
        upd("pos", pos)

    def walk_body(s, w, slot, it):
        nb = w["origin"].shape[0]
        walking = w["walking"]
        hit = traverse.trace_closest(assets.accel, w["origin"],
                                     w["direction"], active=walking)
        vertex = w["vertex"] + walking.to(i64)
        seg_t = torch.where(hit.valid, hit.t, big)
        scene_len = torch.where(walking, w["scene_len"] + seg_t,
                                w["scene_len"])
        if slot == 0 and it == 0:
            s["sp_first_hit_t"] = torch.where(walking, seg_t,
                                              s["sp_first_hit_t"])
        thp, branch, interior = w["thp"], w["branch"], w["interior"]
        origin, direction = w["origin"], w["direction"]

        # miss -> sky plane (StablePlanesHandleMiss, BUILD)
        missed = walking & ~hit.valid
        env_le = EM.eval_dir(assets.env, direction)
        s["sp_stable_radiance"] = s["sp_stable_radiance"] + torch.where(
            missed[:, None], thp * env_le, 0.0)
        ones1 = torch.ones((nb,), dtype=f32, device=dev)
        ones3 = torch.ones((nb, 3), dtype=f32, device=dev)
        store_plane(s, slot, missed, branch, vertex, hit.prim, hit.bary,
                    direction, scene_len, thp, interior, -direction, ones1,
                    ones3, ones3, origin + direction,
                    torch.ones((nb,), dtype=torch.bool, device=dev))

        surf = shading.load_surface(assets.scene, hit.prim, hit.bary,
                                    direction)
        sd = surf.sd
        hit_lane = walking & hit.valid

        # Beer-Lambert absorption along chain segments inside media
        in_medium = ~nested.is_empty(interior)
        top_mat = torch.clamp(nested.top_material(interior), max=mat_last)
        sigma = assets.scene.volume_absorption[top_mat]
        thp = torch.where((hit_lane & in_medium)[:, None],
                          thp * torch.exp(-sigma * hit.t[..., None]), thp)

        # emission along the stable tree is collected once, here (FILL
        # paths on stable branches skip it)
        s["sp_stable_radiance"] = s["sp_stable_radiance"] + torch.where(
            hit_lane[:, None], thp * surf.emission, 0.0)

        bsdf = make_wavefront_bsdf(surf)
        refl_dir, refl_thp, trans_dir, trans_thp, non_delta = \
            _delta_lobes(surf, bsdf)
        path_lum = mu.luminance(thp)
        refl_sig = path_lum * mu.luminance(refl_thp) > K_DELTA_IGNORE
        trans_sig = path_lum * mu.luminance(trans_thp) > K_DELTA_IGNORE
        has_non_delta = non_delta > K_NON_DELTA_IGNORE
        n_lobes = refl_sig.to(i64) + trans_sig.to(i64)

        depth_ok = (vertex < max_vertex_depth) & (vertex < MAX_VERTEX)
        # continue rules (PathTracerStablePlanes.hlsli:150-155): plane 0
        # continues only as pure PSR (one delta lobe), later planes on any
        # delta lobe; a non-delta lobe forces a base
        can_continue = hit_lane & depth_ok & ~has_non_delta & (
            (n_lobes == 1) if slot == 0 else (n_lobes >= 1))

        # reuse lobe: the higher-throughput one (keeps glass view-through
        # on the denoised dominant path)
        take_trans = trans_sig & (
            ~refl_sig | (mu.luminance(trans_thp) >= mu.luminance(refl_thp)))
        cont_dir = torch.where(take_trans[:, None], trans_dir, refl_dir)
        cont_thp = torch.where(take_trans[:, None], trans_thp, refl_thp)
        cont_lobe = torch.where(take_trans, LOBE_ID_TRANSMISSION,
                                LOBE_ID_REFLECTION)

        # enqueue every significant delta lobe except the one the path
        # reuses into free plane slots, junctions that become a base
        # included (PathTracerStablePlanes.hlsli:195-211)
        if slot < P - 1:
            enq_ok = hit_lane & depth_ok

            def enqueue(want, use_primary):
                if use_primary:
                    e_dir, e_thp_f, e_lobe = cont_dir, cont_thp, cont_lobe
                    e_trans = take_trans
                else:
                    e_dir = torch.where(take_trans[:, None], refl_dir,
                                        trans_dir)
                    e_thp_f = torch.where(take_trans[:, None], refl_thp,
                                          trans_thp)
                    e_lobe = torch.where(take_trans, LOBE_ID_REFLECTION,
                                         LOBE_ID_TRANSMISSION)
                    e_trans = ~take_trans
                fork = want & (s["next_free"] < P)
                e_thp = thp * e_thp_f
                e_branch = advance_branch_id(branch, e_lobe)
                e_origin = sd.compute_new_ray_origin(~e_trans)
                e_interior = torch.where(
                    (fork & e_trans & ~sd.thin_surface)[:, None],
                    nested.handle_intersection(
                        interior, sd.material_id, sd.nested_priority,
                        sd.front_facing), interior)
                for tgt in range(slot + 1, P):
                    m = fork & (s["next_free"] == tgt)
                    m2 = m[:, None]
                    for name, val, mm in (
                            ("q_origin", e_origin, m2), ("q_dir", e_dir, m2),
                            ("q_thp", e_thp, m2),
                            ("q_branch", e_branch, m),
                            ("q_interior", e_interior, m2),
                            ("q_scene_len", scene_len, m),
                            ("q_vertex", vertex, m)):
                        arr = s[name]
                        arr[:, tgt] = torch.where(mm, val, arr[:, tgt])
                    s["q_valid"][:, tgt] |= m
                s["next_free"] = s["next_free"] + fork.to(i64)

            primary_sig = torch.where(take_trans, trans_sig, refl_sig)
            sib_sig = torch.where(take_trans, refl_sig, trans_sig)
            # base junctions fork the primary lobe too; the sibling lobe
            # forks in both cases
            enqueue(enq_ok & ~can_continue & primary_sig, True)
            enqueue(enq_ok & sib_sig, False)

        # base vertex: store the plane
        set_base = hit_lane & ~can_continue
        diff_e, spec_e = _bsdf_estimates(surf)
        rough = torch.where(bsdf["alpha"] < B.K_MIN_GGX_ALPHA, 0.0,
                            surf.bsdf_data.roughness)
        store_plane(s, slot, set_base, branch, vertex, hit.prim, hit.bary,
                    direction, scene_len, thp, interior, sd.n, rough,
                    diff_e, spec_e, sd.pos,
                    torch.zeros((nb,), dtype=torch.bool, device=dev))

        # step the chain along the reuse lobe
        stepping = can_continue
        new_interior = torch.where(
            (stepping & take_trans & ~sd.thin_surface)[:, None],
            nested.handle_intersection(interior, sd.material_id,
                                       sd.nested_priority, sd.front_facing),
            interior)
        return dict(
            origin=torch.where(stepping[:, None],
                               sd.compute_new_ray_origin(~take_trans),
                               origin),
            direction=torch.where(stepping[:, None], cont_dir, direction),
            thp=torch.where(stepping[:, None], thp * cont_thp, thp),
            branch=torch.where(stepping, advance_branch_id(branch,
                                                           cont_lobe),
                               branch),
            interior=torch.where(stepping[:, None], new_interior, interior),
            scene_len=scene_len, vertex=vertex, walking=stepping)

    for slot in range(P):
        w = dict(origin=s["q_origin"][:, slot], direction=s["q_dir"][:, slot],
                 thp=s["q_thp"][:, slot], branch=s["q_branch"][:, slot],
                 interior=s["q_interior"][:, slot],
                 scene_len=s["q_scene_len"][:, slot],
                 vertex=s["q_vertex"][:, slot],
                 walking=s["q_valid"][:, slot])
        it = 0
        while it < max_vertex_depth and bool(w["walking"].any()):
            w = walk_body(s, w, slot, it)
            it += 1

    # dominant plane: the highest plane throughput x BSDF estimate
    score = mu.luminance(s["sp_diff_est"] + s["sp_spec_est"])
    score = torch.where(s["sp_branch_id"] != INVALID_BRANCH, score, -1.0)
    s["sp_dominant"] = torch.argmax(score, dim=1)
    return StablePlanes(**{f: s["sp_" + f] for f in _SP_FIELDS})
