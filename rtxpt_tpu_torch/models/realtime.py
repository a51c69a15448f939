"""Real-time renderer: 1 spp + ReSTIR DI/GI + a denoiser + TAA or TAAU
(counterpart of rtxpt_tpu/models/realtime.py; Sample::Render,
Sample.cpp:1660-2269, with Sample::PathTrace and RtxdiPass::Execute,
Sample.cpp:2281-2440).

Two pipelines, on cfg.use_stable_planes:

Stable planes (the RealtimeRenderer default, Config.h:81):
  BUILD   pt/stableplanes.py: the delta-tree walk stores up to 3 planes
  ReSTIR DI on the dominant plane: presample -> candidates -> temporal ->
          spatial (restir/di.py)
  FILL    pt/integrator.render_paths from the plane-0 base (K4's FILL
          variant): noisy paths deposit per-plane diffuse / specular
          radiance and export the secondary surface
  ReSTIR GI on the dominant plane (restir/gi.py); fused DI + GI final
          shading with one visibility trace
  denoise per plane and channel, demodulated (ReLAX or ReBLUR)

PSR-lite (use_stable_planes=False, the realtime_config() default):
  G-buffer pt/gbuffer.trace_gbuffer: the primary surface, replaced along
          the dominant delta branch of mirrors and smooth glass
  ReSTIR DI on it; one BSDF bounce from it and the bounce loop
          (pt/integrator.render_paths, K4 once per bounce) for the
          indirect light; ReSTIR GI on its secondary surface
  denoise the diffuse and specular channels, demodulated

Then TAA (post/taa.py) on the frame, or with `display_size` the TAAU
upscaler (post/taau.py) in its place. All temporal state (reservoirs,
denoiser, TAA and TAAU histories, the previous camera) lives on the
renderer between frames. A frame is one `render` span and each of its
stages a span "realtime/<stage>" (utils/profiling.py; recorded, and ranges
named "rtxpt:realtime/<stage>" in a torch.profiler trace, only while
recording).

With a `mesh` of more than one rank (parallel/meshutils.py; one process a
device) each rank renders its slab of rows: stage 1 on its rows when the
height divides by the mesh size (pt_frame_sharded), else on the whole
frame on every rank; the denoiser on its rows with the neighbours' halo
rows (denoise_taa_sharded); then the ranks gather the composed colour and
the motion, and TAA or TAAU runs on the whole frame on every rank, which
returns the whole frame.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import config as C
from ..core import mathutils as mu
from ..core import rng
from ..denoise import reblur, relax
from ..ops.intersect import Hit
from ..parallel import meshutils
from ..post import taa as taa_mod
from ..post import taau
from ..pt import bsdf as B
from ..pt import gbuffer as GB
from ..pt import integrator, nested, shading
from ..pt import stableplanes as SPM
from ..restir import di, gi
from ..restir.reservoir import Reservoir
from ..scene import envmap as EM
from ..scene.camera import CameraData
from ..utils import profiling
from .renderer import Renderer, r2_jitter, realtime_config

DENOISERS = {"relax": relax, "reblur": reblur}


class FrameOutputs(NamedTuple):
    """What the PSR-lite stage 1 hands stage 2 and the next frame."""
    di_diffuse: torch.Tensor        # (H,W,3)
    di_specular: torch.Tensor
    indirect_diffuse: torch.Tensor
    indirect_specular: torch.Tensor
    motion: torch.Tensor            # (H,W,2)
    normal: torch.Tensor            # (H,W,3)
    view_z: torch.Tensor            # (H,W)
    diffuse_albedo: torch.Tensor    # (H,W,3)
    specular_albedo: torch.Tensor
    roughness: torch.Tensor         # (H,W)
    emission_bg: torch.Tensor       # (H,W,3)
    psr_thp: torch.Tensor           # (H,W,3)
    reservoir: Reservoir            # DI feedback
    gi_reservoir: gi.GIReservoir    # GI feedback
    gb_normal: torch.Tensor         # (N,3)
    gb_view_z: torch.Tensor         # (N,)


def _pt_frame(assets, cam: CameraData, prev_cam: CameraData,
              prev_res: Optional[Reservoir],
              prev_gi: Optional[gi.GIReservoir], prev_gb_normal, prev_gb_z,
              px, py, consts, *, cfg: C.PTConfig, width: int, height: int,
              has_prev: bool, y0: int = 0, rows: Optional[int] = None,
              prev_rows: Optional[int] = None) -> FrameOutputs:
    """PSR-lite stage 1: the G-buffer, ReSTIR DI, the indirect paths and
    ReSTIR GI.

    The row window (parallel/meshutils.pt_frame_sharded): px, py are
    `rows` rows of the frame from global row y0, and the previous frame's
    buffers `prev_rows` rows centred on them (halo rows above and below).
    The defaults are the whole frame."""
    rows = height if rows is None else rows
    prev_rows = rows if prev_rows is None else prev_rows
    win = dict(y0=y0, rows=rows)
    prev_win = dict(win, prev_y0=y0 - (prev_rows - rows) // 2,
                    prev_rows=prev_rows)
    n = px.shape[0]
    dev = px.device
    with profiling.span("realtime/gbuffer"):
        gb = GB.trace_gbuffer(assets, cam, prev_cam, px, py)
    frame = int(consts.sample_base_index)
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    # ReSTIR DI; the temporal output, not the spatial one, feeds the next
    # frame (RTXDI: spatially merged feedback loops energy)
    di_d = di_s = z3
    if cfg.use_restir_di:
        with profiling.span("realtime/restir_di"):
            ris = di.presample_lights(assets, frame)
            r = di.generate_candidates(assets, gb, px, py, frame, ris)
            if has_prev and prev_res is not None:
                r = di.temporal_resample(assets, gb, r, prev_res,
                                         prev_gb_normal, prev_gb_z, px, py,
                                         width, height, frame, **prev_win)
            r_feedback = r
            r = di.spatial_resample(assets, gb, r, px, py, width, height,
                                    frame, **win)
            if not cfg.use_restir_gi:
                di_d, di_s = di.final_shade(
                    assets, gb, r, exact_alpha=cfg.exact_alpha_test)
    else:
        r_feedback = Reservoir.empty(n, dev)

    # indirect: one BSDF bounce at the primary surface, then the bounce
    # loop from the secondary vertex
    with profiling.span("realtime/paths"):
        sd = gb.surface.sd
        g = rng.make(px, py, 1, frame)
        g = rng.start_effect(g, rng.EFFECT_SCATTER_BSDF, True)
        g, u3 = rng.next_3d(g)
        bsdf = shading.make_wavefront_bsdf(gb.surface)
        bs = B.sample(bsdf, sd.to_local(sd.v), u3.unbind(-1))
        wo_world = torch.stack(B.from_local(
            bs["wo"], sd.t.unbind(-1), sd.b.unbind(-1), sd.n.unbind(-1)), -1)
        weight = torch.stack(bs["weight"], -1)
        lobe = bs["lobe"].to(torch.int32)
        is_delta = (lobe & B.LOBE_DELTA) != 0
        is_trans = (lobe & B.LOBE_TRANSMISSION) != 0
        is_refl = (lobe & B.LOBE_REFLECTION) != 0
        rough = torch.where(bsdf["alpha"] < B.K_MIN_GGX_ALPHA, 0.0,
                            bsdf["roughness"])
        primary_diffuse = is_refl & (
            ((lobe & B.LOBE_DIFFUSE_REFLECTION) != 0)
            | (rough > integrator.K_SPECULAR_ROUGHNESS_THRESHOLD))
        active = gb.valid & bs["valid"] & torch.any(weight > 0.0, -1)
        # the nested stack after the delta chain, entered on transmission
        interior = torch.where(
            (active & is_trans & ~sd.thin_surface)[..., None],
            nested.handle_intersection(gb.interior, sd.material_id,
                                       sd.nested_priority, sd.front_facing),
            gb.interior)
        # ReSTIR DI covers the primary direct light of non-delta reflection
        # lobes only (its visibility rays leave on the view side); the
        # others keep their BSDF-sampled emissive and env MIS
        # (PathTracerNEE.hlsli:321-330)
        restir_covers = ~is_delta & ~is_trans if cfg.use_restir_di             else torch.zeros_like(is_delta)
        mis0 = torch.where(restir_covers, 0.0, 1.0)
        spread = cam.pixel_cone_spread_angle
        cone_spread = torch.where(
            is_delta, spread,
            spread + mu.spread_angle_from_scatter_pdf(
                torch.clamp(bs["pdf"], min=1e-8)))
        ones = torch.ones((n,), dtype=torch.float32, device=dev)
        # unit initial throughput: the loop returns Lo(secondary ->
        # primary), which the composition weighs by the BSDF weight or
        # the ReSTIR GI reservoir (PathTracer.hlsli:170-175)
        path0 = integrator.PathState(
            origin=sd.compute_new_ray_origin(is_refl), direction=wo_world,
            thp=torch.ones((n, 3), dtype=torch.float32, device=dev),
            radiance=z3, active=active,
            vertex_index=torch.ones((n,), dtype=torch.int32, device=dev),
            diffuse_bounces=primary_diffuse.to(torch.int32),
            rejected_hits=torch.zeros((n,), dtype=torch.int32, device=dev),
            scene_length=gb.t,
            firefly_k=mu.new_scatter_firefly_filter_k(ones, bs["pdf"],
                                                      bs["lobe_p"]),
            cone_width=gb.t * spread, cone_spread=cone_spread,
            interior=interior, emissive_mis=mis0, env_mis=mis0, px=px,
            py=py)
        lo, (sec_pos, sec_nrm, sec_found) = integrator.render_paths(
            assets, cam, path0, consts, cfg=cfg, capture_first_hit=True)

    plain_ind = weight * lo
    to_diffuse = (primary_diffuse | ~gb.valid)[..., None]
    ind_d = torch.where(to_diffuse, plain_ind, 0.0)
    ind_s = torch.where(to_diffuse, 0.0, plain_ind)
    if cfg.use_restir_gi:
        with profiling.span("realtime/restir_gi"):
            gi_ok = active & sec_found & ~is_delta & ~is_trans & \
                (bs["pdf"] > 0.0)
            gr = gi.make_initial(gb, sec_pos, sec_nrm, gi_ok, lo, bs["pdf"])
            if has_prev and prev_gi is not None:
                gr = gi.temporal_resample(gb, gr, prev_gi, prev_gb_normal,
                                          prev_gb_z, px, py, width, height,
                                          frame, **prev_win)
            gi_feedback = gr
            gr = gi.spatial_resample(gb, gr, px, py, width, height, frame,
                                     **win)
            if cfg.use_restir_di:
                di_d, di_s, gi_d, gi_s = di.fused_final_shade(
                    assets, gb, r, gr, exact_alpha=cfg.exact_alpha_test)
            else:
                gi_d, gi_s = gi.final_shade(
                    assets, gb, gr, exact_alpha=cfg.exact_alpha_test)
        ind_d = torch.where(gi_ok[..., None], gi_d, ind_d)
        ind_s = torch.where(gi_ok[..., None], gi_s, ind_s)
    else:
        gi_feedback = gi.GIReservoir.empty(n, dev)

    # the background and the primary emission; the sky seen through a
    # delta chain is weighed by the chain's throughput
    env_bg = torch.where(gb.valid[..., None], 0.0,
                         gb.psr_thp * EM.eval_dir(assets.env, gb.view_dir))
    shp = (rows, width)
    r3 = lambda a: a.reshape(shp + (3,))
    return FrameOutputs(
        di_diffuse=r3(di_d), di_specular=r3(di_s),
        indirect_diffuse=r3(ind_d), indirect_specular=r3(ind_s),
        motion=gb.motion.reshape(shp + (2,)), normal=r3(gb.normal),
        view_z=gb.view_z.reshape(shp), diffuse_albedo=r3(gb.diffuse_albedo),
        specular_albedo=r3(gb.specular_albedo),
        roughness=gb.roughness.reshape(shp),
        emission_bg=r3(gb.emission + env_bg), psr_thp=r3(gb.psr_thp),
        reservoir=r_feedback, gi_reservoir=gi_feedback,
        gb_normal=gb.normal, gb_view_z=gb.view_z)


def _post_frame(out: FrameOutputs, den_diff, den_spec, taa_state, *,
                use_den: bool, use_taa: bool, method: str = "relax",
                den=None):
    """PSR-lite stage 2: demodulate, denoise (`den`'s `denoise`, by
    default the method's module), compose, TAA. Returns (colour, diffuse
    and specular denoiser states, TAA state)."""
    eps = 1e-3
    diff_in = (out.di_diffuse + out.indirect_diffuse) / torch.clamp(
        out.diffuse_albedo, min=eps)
    spec_in = (out.di_specular + out.indirect_specular) / torch.clamp(
        out.specular_albedo, min=eps)
    relax_mask = None
    if use_den:
        with profiling.span(f"realtime/{method}"):
            den = den or DENOISERS[method]
            diff_f, den_diff = den.denoise(den_diff, diff_in, out.normal,
                                           out.view_z, out.motion)
            spec_f, den_spec = den.denoise(den_spec, spec_in, out.normal,
                                           out.view_z, out.motion,
                                           roughness=out.roughness,
                                           iterations=3)
        # the history reset relaxes TAA's clamp
        relax_mask = torch.clamp(2.0 - den_diff.history, 0.0, 1.0)
    else:
        diff_f, spec_f = diff_in, spec_in
    color = out.emission_bg + out.psr_thp * (
        diff_f * out.diffuse_albedo + spec_f * out.specular_albedo)
    if use_taa:
        with profiling.span("realtime/taa"):
            color, taa_state = taa_mod.resolve(taa_state, color, out.motion,
                                               relax_mask=relax_mask)
    return color, den_diff, den_spec, taa_state


def _dsel(arr, dom):
    """arr[i, dom[i]] of an (N, P, ...) array."""
    idx = dom.reshape((-1,) + (1,) * (arr.dim() - 1))
    idx = idx.expand((-1, 1) + tuple(arr.shape[2:]))
    return torch.gather(arr, 1, idx)[:, 0]


def dominant_gbuffer(assets, sp: SPM.StablePlanes) -> GB.GBuffer:
    """The dominant plane's G-buffer: RTXDI's surface data export
    (ExportVisibilityBuffer.hlsl reading the dominant plane)."""
    dom = sp.dominant
    d_prim = _dsel(sp.prim, dom)
    d_bary = _dsel(sp.bary, dom)
    d_dir = _dsel(sp.ray_dir, dom)
    surf_d = shading.load_surface(assets.scene, d_prim, d_bary, d_dir)
    return GB.GBuffer(
        valid=d_prim >= 0, prim=d_prim, bary=d_bary,
        t=_dsel(sp.scene_length, dom), pos=surf_d.sd.pos,
        normal=surf_d.sd.n, face_normal=surf_d.sd.face_n,
        view_z=_dsel(sp.view_z, dom), roughness=_dsel(sp.roughness, dom),
        diffuse_albedo=_dsel(sp.diff_est, dom),
        specular_albedo=_dsel(sp.spec_est, dom),
        emission=torch.zeros_like(surf_d.sd.pos),
        motion=_dsel(sp.motion, dom), view_dir=d_dir, psr_thp=_dsel(sp.thp, dom),
        interior=_dsel(sp.interior, dom), surface=surf_d)


def _pt_frame_stable(assets, cam: CameraData, prev_cam: CameraData,
                     prev_res: Optional[Reservoir],
                     prev_gi: Optional[gi.GIReservoir], prev_gb_normal,
                     prev_gb_z, px, py, consts, *, cfg: C.PTConfig,
                     width: int, height: int, has_prev: bool, y0: int = 0,
                     rows: Optional[int] = None,
                     prev_rows: Optional[int] = None):
    """Stage 1: BUILD -> ReSTIR DI on the dominant plane -> FILL -> ReSTIR
    GI -> the per-plane radiance channels. Returns (planes, committed
    diffuse (N,P,4), committed specular (N,P,4), specular motion (N,P,2),
    DI feedback reservoir, GI feedback reservoir, G-buffer normal and
    view depth, (DI, GI) initial reservoirs: the candidates and the
    path-traced secondary sample before temporal reuse). y0/rows/
    prev_rows: the row window, as in _pt_frame."""
    rows = height if rows is None else rows
    prev_rows = rows if prev_rows is None else prev_rows
    win = dict(y0=y0, rows=rows)
    prev_win = dict(win, prev_y0=y0 - (prev_rows - rows) // 2,
                    prev_rows=prev_rows)
    n = px.shape[0]
    dev = px.device
    P = cfg.stable_plane_count
    with profiling.span("realtime/build"):
        sp = SPM.build_stable_planes(
            assets, cam, prev_cam, px, py, plane_count=P,
            max_vertex_depth=cfg.max_stable_plane_vertex_depth,
            compaction=cfg.wavefront_compaction,
            compaction_min=cfg.wavefront_compaction_min)
        dom = sp.dominant
        gb = dominant_gbuffer(assets, sp)
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    frame = int(consts.sample_base_index)

    di_d = di_s = gi_d = gi_s = z3
    if cfg.use_restir_di:
        with profiling.span("realtime/restir_di"):
            ris = di.presample_lights(assets, frame)
            r = di.generate_candidates(assets, gb, px, py, frame, ris)
            r_initial = r
            if has_prev and prev_res is not None:
                r = di.temporal_resample(assets, gb, r, prev_res,
                                         prev_gb_normal, prev_gb_z, px, py,
                                         width, height, frame, **prev_win)
            # the temporal output, not the spatial one, feeds the next
            # frame (RTXDI: spatially merged feedback loops energy)
            r_feedback = r
            r = di.spatial_resample(assets, gb, r, px, py, width, height,
                                    frame, **win)
            profiling.count_device("restir_di.valid",
                                   lambda: (r.light != di.LIGHT_INVALID).sum())
            if not cfg.use_restir_gi:
                di_d, di_s = di.final_shade(
                    assets, gb, r, exact_alpha=cfg.exact_alpha_test)
    else:
        r_feedback = r_initial = Reservoir.empty(n, dev)

    # ---- FILL from the plane-0 base (firstHitFromBasePlane)
    with profiling.span("realtime/fill"):
        fill_cfg = dataclasses.replace(cfg, mode=C.MODE_FILL_STABLE_PLANES)
        z1 = torch.zeros((n,), dtype=torch.float32, device=dev)
        z4 = torch.zeros((n, 4), dtype=torch.float32, device=dev)
        no = torch.zeros((n,), dtype=torch.bool, device=dev)
        zi = torch.zeros((n,), dtype=torch.int32, device=dev)
        base_valid = sp.prim[:, 0] >= 0
        path0 = integrator.PathState(
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
        injected = Hit(t=sp.scene_length[:, 0], prim=sp.prim[:, 0],
                       bary=sp.bary[:, 0])
        fill = integrator.render_paths(
            assets, cam, path0, consts, cfg=fill_cfg,
            capture_first_hit=cfg.use_restir_gi, injected_hit=injected)
    committed_diff = fill["committed_diff"]
    committed_spec = fill["committed_spec"]

    if cfg.use_restir_gi:
        with profiling.span("realtime/restir_gi"):
            sec_pos, sec_nrm, sec_found = fill["first"]
            lo = fill["gi_l"] / torch.clamp(fill["gi_thp"], min=1e-6)
            gr = gi.make_initial(gb, sec_pos, sec_nrm,
                                 fill["gi_valid"] & sec_found, lo,
                                 fill["gi_pdf"])
            gr_initial = gr
            if has_prev and prev_gi is not None:
                gr = gi.temporal_resample(gb, gr, prev_gi, prev_gb_normal,
                                          prev_gb_z, px, py, width, height,
                                          frame, **prev_win)
            gi_feedback = gr
            gr = gi.spatial_resample(gb, gr, px, py, width, height, frame,
                                     **win)
            profiling.count_device("restir_gi.valid", lambda: gr.valid.sum())
            if cfg.use_restir_di:
                di_d, di_s, gi_d, gi_s = di.fused_final_shade(
                    assets, gb, r, gr, exact_alpha=cfg.exact_alpha_test)
            else:
                gi_d, gi_s = gi.final_shade(
                    assets, gb, gr, exact_alpha=cfg.exact_alpha_test)
    else:
        gi_feedback = gr_initial = gi.GIReservoir.empty(n, dev)

    # fold the ReSTIR DI + GI radiance at the dominant base (weighted by
    # the plane throughput, like the committed channels) into the
    # dominant plane's channels
    dom_oh = (torch.arange(P, device=dev)[None, :] == dom[:, None])[..., None]
    thp_dom = _dsel(sp.thp, dom)
    hit_td = _dsel(sp.view_z, dom)[:, None]

    def fold(chan, add):
        add = (add * thp_dom)[:, None] * torch.ones((1, P, 1), device=dev)
        return torch.where(dom_oh, SPM.combine_hit_t(chan, add, hit_td), chan)

    committed_diff = fold(committed_diff, di_d + gi_d)
    committed_spec = fold(committed_spec, di_s + gi_s)

    # hitT-based virtual reprojection of specular (NRD virtual motion): a
    # mirror-like surface's specular history lies at the reflected point
    spec_hit_t = committed_spec[..., 3]
    virt_pos = sp.pos + sp.ray_dir * spec_hit_t[..., None]
    prev_xy_virt, _ = GB.project_to_screen(prev_cam, virt_pos)
    cur_xy = torch.stack([px.to(torch.float32), py.to(torch.float32)],
                         -1)[:, None, :]
    w_virt = torch.clamp(1.0 - sp.roughness * 4.0, 0.0, 1.0) * \
        (spec_hit_t > 0.0)
    spec_motion = sp.motion + (prev_xy_virt - cur_xy - sp.motion) \
        * w_virt[..., None]
    return (sp, committed_diff, committed_spec, spec_motion, r_feedback,
            gi_feedback, gb.normal, gb.view_z, (r_initial, gr_initial))


def dominant_motion(sp: SPM.StablePlanes, height: int, width: int):
    """(H,W,2) motion of each pixel's dominant plane: TAA's and TAAU's."""
    dom_oh = (torch.arange(sp.count, device=sp.motion.device)[None, :]
              == sp.dominant[:, None])
    return torch.sum(sp.motion * dom_oh[..., None], dim=1).reshape(
        height, width, 2)


def _post_frame_stable(sp, committed_diff, committed_spec, spec_motion,
                       den_states, taa_state, *, width: int, height: int,
                       use_den: bool, use_taa: bool, method: str = "relax",
                       den=None):
    """Stage 2: per plane demodulate -> denoise (ReLAX, or ReBLUR with the
    channel's hit distance; `den`'s `denoise` where given: the mesh's
    ReLAX) -> remodulate -> merge with the stable
    radiance -> TAA (Sample::Denoise, Sample.cpp:2398-2440, and
    PostProcess's final merge). Returns (colour, denoiser states, TAA
    state, per-plane (diffuse, specular) outputs)."""
    P = committed_diff.shape[1]
    shp = (height, width)
    eps = 1e-3
    color = sp.stable_radiance.reshape(shp + (3,))
    new_den, plane_diff, plane_spec = [], [], []
    den = den or DENOISERS[method]
    with profiling.span(f"realtime/{method}"):
        for p in range(P):
            diff_est = sp.diff_est[:, p].reshape(shp + (3,))
            spec_est = sp.spec_est[:, p].reshape(shp + (3,))
            d_in = committed_diff[:, p, :3].reshape(shp + (3,)) \
                / torch.clamp(diff_est, min=eps)
            s_in = committed_spec[:, p, :3].reshape(shp + (3,)) \
                / torch.clamp(spec_est, min=eps)
            normal = sp.normal[:, p].reshape(shp + (3,))
            view_z = sp.view_z[:, p].reshape(shp)
            valid = (sp.branch_id[:, p] != SPM.INVALID_BRANCH).reshape(
                shp)[..., None]
            if use_den:
                dd, ds = den_states[p]
                # ReBLUR's radius follows the channel's hit distance
                hit_d = dict(hit_t=committed_diff[:, p, 3].reshape(shp)) \
                    if method == "reblur" else {}
                hit_s = dict(hit_t=committed_spec[:, p, 3].reshape(shp)) \
                    if method == "reblur" else {}
                d_f, dd = den.denoise(dd, d_in, normal, view_z,
                                      sp.motion[:, p].reshape(shp + (2,)),
                                      **hit_d)
                s_f, ds = den.denoise(
                    ds, s_in, normal, view_z,
                    spec_motion[:, p].reshape(shp + (2,)),
                    roughness=sp.roughness[:, p].reshape(shp), iterations=3,
                    **hit_s)
                new_den.append((dd, ds))
            else:
                d_f, s_f = d_in, s_in
                new_den.append(den_states[p])
            pd = torch.where(valid, d_f * diff_est, 0.0)
            ps = torch.where(valid, s_f * spec_est, 0.0)
            plane_diff.append(pd)
            plane_spec.append(ps)
            color = color + pd + ps
    if use_taa:
        with profiling.span("realtime/taa"):
            motion_dom = dominant_motion(sp, height, width)
            relax_mask = None
            if use_den:
                # plane 0's diffuse history (every pixel has plane 0)
                # drives the clamp relax
                relax_mask = torch.clamp(2.0 - new_den[0][0].history, 0.0,
                                         1.0)
            color, taa_state = taa_mod.resolve(taa_state, color, motion_dom,
                                               relax_mask=relax_mask)
    return color, new_den, taa_state, (torch.stack(plane_diff),
                                       torch.stack(plane_spec))


class RealtimeRenderer(Renderer):
    """Frame-loop driver of the realtime mode (DeviceManager::
    RunMessageLoop + Sample::Render). `animate` (Renderer's) replaces
    `self.assets` between frames; every stage of `render_frame` reads the
    assets it is given, so nothing of the old pose is cached, and the
    temporal histories carry across the pose change, as in the reference
    (rtxpt_tpu/models/realtime.py:638-861).

    mesh: a parallel/meshutils.Mesh; the renderer works on the mesh's
    device. With more than one rank every rank renders its rows and
    render_frame returns the whole frame on every rank; the stage-1
    feedback and the denoiser histories hold the rank's rows (`last_*`
    too), the TAA and TAAU histories the whole frame."""

    def __init__(self, host_scene, camera, cfg: Optional[C.PTConfig] = None,
                 mesh=None, **kw):
        # the reference's realtime default: the 3-plane stable-planes
        # decomposition (RTXPT/PathTracer/Config.h:81); use_stable_planes=
        # False renders PSR-lite
        cfg = cfg or realtime_config(use_restir_di=True, use_restir_gi=True,
                                     denoiser_enabled=True,
                                     use_stable_planes=True)
        if cfg.denoiser_method not in DENOISERS:
            raise ValueError(f"denoiser_method {cfg.denoiser_method!r} is "
                             f"not one of {sorted(DENOISERS)}")
        if mesh is not None:
            # the reference's sharded post runs ReLAX whatever the method
            # (rtxpt_tpu/parallel/meshutils.py:222); refuse, not switch
            if mesh.size > 1 and cfg.denoiser_method != "relax":
                raise ValueError(f"denoiser_method {cfg.denoiser_method!r}"
                                 " with a mesh of more than one rank: the "
                                 "sharded post runs ReLAX only")
            kw.setdefault("device", mesh.device)
            if torch.device(kw["device"]).type != mesh.device.type:
                raise ValueError(f"device {kw['device']} is not the mesh's "
                                 f"{mesh.device}")
        super().__init__(host_scene, camera, cfg, **kw)
        self.mesh = mesh
        self.frame_index = 0
        self.prev_cam = self.camera
        self.prev_reservoir = None
        self.prev_gi = None
        self.prev_gb_normal = None
        self.prev_gb_z = None
        self.den_diff = None        # PSR-lite: diffuse / specular states
        self.den_spec = None
        self.den_states = None      # stable planes: per plane (diff, spec)
        self.taa_state = None
        self.taau_state = None      # display-size upscaler history
        # debug sources: PSR-lite fills last_outputs, stable planes the rest
        self.last_outputs = None
        self.last_stable_planes = None
        self.last_plane_radiance = None   # (committed diff, spec) (N,P,4)
        self.last_plane_denoised = None   # (P,H,W,3) diff / spec stacks
        self.last_restir_initial = None   # (DI, GI) reservoirs before
        #                                   temporal reuse

    def _shard_stage1(self, height: int) -> bool:
        """Stage 1 runs on each rank's rows when they divide evenly;
        otherwise every rank runs the whole stage 1 and only the post
        shards (the reference's rule)."""
        return (self.mesh is not None and self.mesh.size > 1
                and height % self.mesh.size == 0)

    def render_frame(self, width: int, height: int,
                     camera: Optional[CameraData] = None,
                     denoise: Optional[bool] = None, taa: bool = True,
                     display_size: Optional[tuple] = None):
        """Render one frame at (width, height); returns linear HDR
        (H,W,3). With `display_size` = (Wd, Hd) the TAAU upscaler takes
        TAA's place and returns (Hd,Wd,3) (the DLSS slot: render size !=
        display size, Sample.cpp:1733-1781). One `render` span (the
        recorder's call)."""
        with profiling.span("render"):
            return self._frame(width, height, camera, denoise, taa,
                               display_size)

    def _frame(self, width: int, height: int, camera, denoise, taa: bool,
               display_size):
        cam = (camera or self.camera).to(self.device)
        jit = r2_jitter(self.frame_index) if self.cfg.realtime_noise \
            else (0.0, 0.0)
        cam = cam._replace(
            jitter=self._to_device(jit, torch.float32),
            viewport=self._to_device([width, height], torch.float32))
        px, py = self._pixel_grid(width, height)
        consts = C.default_constants(sample_base_index=self.frame_index)
        has_prev = self.prev_reservoir is not None
        sharded = self._shard_stage1(height)
        if sharded:
            rows = height // self.mesh.size
            own = slice(self.mesh.rank * rows * width,
                        (self.mesh.rank + 1) * rows * width)
            px, py = px[own], py[own]
        n = px.shape[0]
        z = lambda *s: torch.zeros((n,) + s, dtype=torch.float32,
                                   device=self.device)
        prev_n = self.prev_gb_normal if has_prev else z(3)
        prev_z = self.prev_gb_z if has_prev else z()
        use_den = self.cfg.denoiser_enabled if denoise is None else denoise
        taa = taa and display_size is None
        # the post runs on each rank's rows where stage 1 did or the
        # denoiser needs it (the reference's rule); else as one device
        post_sharded = self.mesh is not None and self.mesh.size > 1 and (
            sharded or use_den)
        method = self.cfg.denoiser_method
        frame = dict(width=width, height=height, has_prev=has_prev)
        stage1_args = (self.assets, cam, self.prev_cam, self.prev_reservoir,
                       self.prev_gi, prev_n, prev_z, px, py, consts)
        kind = "stable" if self.cfg.use_stable_planes else "psr"
        if sharded:
            out = meshutils.pt_frame_sharded(self.mesh, kind, self.cfg,
                                             *stage1_args, **frame)
        else:
            out = (_pt_frame_stable if kind == "stable" else _pt_frame)(
                *stage1_args, cfg=self.cfg, **frame)
        post = dict(use_den=use_den, method=method,
                    use_taa=taa and not post_sharded)
        if post_sharded:
            # ReLAX on the rank's rows; TAA on the gathered frame below
            post["den"] = meshutils.ShardedReLAX(self.mesh, height)
        if kind == "stable":
            (sp, cdiff, cspec, smot, r_fb, gi_fb, gb_normal, gb_z,
             self.last_restir_initial) = out
            if self.den_states is None:
                self.den_states = [(None, None)] * \
                    self.cfg.stable_plane_count
            self.last_plane_radiance = (cdiff, cspec)
            self.last_stable_planes = sp
            if post_sharded and not sharded:
                # stage 1 ran on the whole frame: the post takes the
                # rank's rows
                flat = lambda a: meshutils.shard_rows(self.mesh, a.reshape(
                    (height, width) + a.shape[1:])).reshape(
                        (-1,) + a.shape[1:])
                sp = type(sp)(*map(flat, sp))
                cdiff, cspec, smot = flat(cdiff), flat(cspec), flat(smot)
            rows = sp.dominant.shape[0] // width
            (color, self.den_states, self.taa_state,
             self.last_plane_denoised) = _post_frame_stable(
                sp, cdiff, cspec, smot, self.den_states, self.taa_state,
                width=width, height=rows, **post)
            motion = dominant_motion(sp, rows, width) \
                if post_sharded or display_size is not None else None
        else:
            self.last_outputs = out
            r_fb, gi_fb = out.reservoir, out.gi_reservoir
            gb_normal, gb_z = out.gb_normal, out.gb_view_z
            if post_sharded and not sharded:
                out = out._replace(**{
                    f: meshutils.shard_rows(self.mesh, getattr(out, f))
                    for f in out._fields
                    if f not in ("reservoir", "gi_reservoir", "gb_normal",
                                 "gb_view_z")})
            color, self.den_diff, self.den_spec, self.taa_state = \
                _post_frame(out, self.den_diff, self.den_spec,
                            self.taa_state, **post)
            motion = out.motion
        if post_sharded:
            # what cannot be split by rows runs on the gathered frame
            color, motion = self._gather_frame(
                color, motion if taa or display_size is not None else None,
                height)
            if taa:
                # the reference's sharded post resolves TAA without the
                # denoiser's clamp relax (rtxpt_tpu/models/realtime.py:710)
                with profiling.span("realtime/taa"):
                    color, self.taa_state = taa_mod.resolve(
                        self.taa_state, color, motion)
        self.prev_cam = cam
        self.prev_reservoir = r_fb
        self.prev_gi = gi_fb
        self.prev_gb_normal = gb_normal
        self.prev_gb_z = gb_z
        self.frame_index += 1
        if display_size is not None:
            with profiling.span("realtime/taau"):
                color, self.taau_state = taau.resolve(
                    self.taau_state, color, motion, display_size, jitter=jit)
        return color

    def _gather_frame(self, color, motion, height: int):
        """The whole frame's colour, and motion where `motion` is given,
        from every rank's rows: one gather."""
        if motion is None:
            return meshutils.gather_rows(self.mesh, color, height), None
        both = meshutils.gather_rows(self.mesh, torch.cat([color, motion],
                                                          -1), height)
        return both[..., :3], both[..., 3:]
