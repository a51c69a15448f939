"""Real-time renderer: 1 spp + stable planes + ReSTIR DI/GI + ReLAX + TAA
(counterpart of rtxpt_tpu/models/realtime.py; Sample::Render,
Sample.cpp:1660-2269, with Sample::PathTrace and RtxdiPass::Execute,
Sample.cpp:2281-2440).

One frame, on one device:

  BUILD   pt/stableplanes.py: the delta-tree walk stores up to 3 planes
  ReSTIR DI on the dominant plane: presample -> candidates -> temporal ->
          spatial (restir/di.py)
  FILL    pt/integrator.render_paths from the plane-0 base (K4's FILL
          variant): noisy paths deposit per-plane diffuse / specular
          radiance and export the secondary surface
  ReSTIR GI on the dominant plane (restir/gi.py); fused DI + GI final
          shading with one visibility trace
  ReLAX   per plane and channel, demodulated (denoise/relax.py)
  TAA     post/taa.py on the merged frame

All temporal state (reservoirs, denoiser and TAA histories, the previous
camera) lives on the renderer between frames. Each stage runs inside a
profiler range named "realtime:<stage>" (tools_torch/profile_render.py
reads them). Not carried yet: the PSR-lite single-plane pipeline
(`use_stable_planes=False`), ReBLUR, TAAU (`display_size`), multi-device
meshes and animation; each raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import config as C
from ..denoise import relax
from ..ops.intersect import Hit
from ..post import taa as taa_mod
from ..pt import gbuffer as GB
from ..pt import integrator, shading
from ..pt import stableplanes as SPM
from ..restir import di, gi
from ..restir.reservoir import Reservoir
from ..scene.camera import CameraData
from .renderer import Renderer, r2_jitter, realtime_config

_range = torch.profiler.record_function


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
                     width: int, height: int, has_prev: bool):
    """Stage 1: BUILD -> ReSTIR DI on the dominant plane -> FILL -> ReSTIR
    GI -> the per-plane radiance channels. Returns (planes, committed
    diffuse (N,P,4), committed specular (N,P,4), specular motion (N,P,2),
    DI feedback reservoir, GI feedback reservoir, G-buffer normal and
    view depth)."""
    n = px.shape[0]
    dev = px.device
    P = cfg.stable_plane_count
    with _range("realtime:build"):
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
        with _range("realtime:restir_di"):
            ris = di.presample_lights(assets, frame)
            r = di.generate_candidates(assets, gb, px, py, frame, ris)
            if has_prev and prev_res is not None:
                r = di.temporal_resample(assets, gb, r, prev_res,
                                         prev_gb_normal, prev_gb_z, px, py,
                                         width, height, frame)
            # the temporal output, not the spatial one, feeds the next
            # frame (RTXDI: spatially merged feedback loops energy)
            r_feedback = r
            r = di.spatial_resample(assets, gb, r, px, py, width, height,
                                    frame)
            if not cfg.use_restir_gi:
                di_d, di_s = di.final_shade(assets, gb, r)
    else:
        r_feedback = Reservoir.empty(n, dev)

    # ---- FILL from the plane-0 base (firstHitFromBasePlane)
    with _range("realtime:fill"):
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
        with _range("realtime:restir_gi"):
            sec_pos, sec_nrm, sec_found = fill["first"]
            lo = fill["gi_l"] / torch.clamp(fill["gi_thp"], min=1e-6)
            gr = gi.make_initial(gb, sec_pos, sec_nrm,
                                 fill["gi_valid"] & sec_found, lo,
                                 fill["gi_pdf"])
            if has_prev and prev_gi is not None:
                gr = gi.temporal_resample(gb, gr, prev_gi, prev_gb_normal,
                                          prev_gb_z, px, py, width, height,
                                          frame)
            gi_feedback = gr
            gr = gi.spatial_resample(gb, gr, px, py, width, height, frame)
            if cfg.use_restir_di:
                di_d, di_s, gi_d, gi_s = di.fused_final_shade(assets, gb, r,
                                                              gr)
            else:
                gi_d, gi_s = gi.final_shade(assets, gb, gr)
    else:
        gi_feedback = gi.GIReservoir.empty(n, dev)

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
            gi_feedback, gb.normal, gb.view_z)


def _post_frame_stable(sp, committed_diff, committed_spec, spec_motion,
                       den_states, taa_state, *, width: int, height: int,
                       use_den: bool, use_taa: bool):
    """Stage 2: per plane demodulate -> ReLAX -> remodulate -> merge with
    the stable radiance -> TAA (Sample::Denoise, Sample.cpp:2398-2440, and
    PostProcess's final merge). Returns (colour, denoiser states, TAA
    state, per-plane (diffuse, specular) outputs)."""
    P = committed_diff.shape[1]
    shp = (height, width)
    eps = 1e-3
    color = sp.stable_radiance.reshape(shp + (3,))
    new_den, plane_diff, plane_spec = [], [], []
    with _range("realtime:relax"):
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
                d_f, dd = relax.denoise(dd, d_in, normal, view_z,
                                        sp.motion[:, p].reshape(shp + (2,)))
                s_f, ds = relax.denoise(
                    ds, s_in, normal, view_z,
                    spec_motion[:, p].reshape(shp + (2,)),
                    roughness=sp.roughness[:, p].reshape(shp), iterations=3)
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
        with _range("realtime:taa"):
            dom_oh = (torch.arange(P, device=color.device)[None, :]
                      == sp.dominant[:, None])
            motion_dom = torch.sum(sp.motion * dom_oh[..., None],
                                   dim=1).reshape(shp + (2,))
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
    RunMessageLoop + Sample::Render)."""

    def __init__(self, host_scene, camera, cfg: Optional[C.PTConfig] = None,
                 mesh=None, **kw):
        # the reference's realtime default: the 3-plane stable-planes
        # decomposition (RTXPT/PathTracer/Config.h:81)
        cfg = cfg or realtime_config(use_restir_di=True, use_restir_gi=True,
                                     denoiser_enabled=True,
                                     use_stable_planes=True)
        if mesh is not None:
            raise NotImplementedError("multi-device realtime frames are "
                                      "not ported yet")
        if not cfg.use_stable_planes:
            raise NotImplementedError("the PSR-lite single-plane pipeline "
                                      "(use_stable_planes=False) is not "
                                      "ported yet")
        if cfg.denoiser_method != "relax":
            raise NotImplementedError(f"denoiser {cfg.denoiser_method!r} "
                                      "is not ported yet (ReLAX is)")
        super().__init__(host_scene, camera, cfg, **kw)
        self.frame_index = 0
        self.prev_cam = self.camera
        self.prev_reservoir = None
        self.prev_gi = None
        self.prev_gb_normal = None
        self.prev_gb_z = None
        self.den_states = None      # per plane: (diffuse, specular) state
        self.taa_state = None
        self.last_stable_planes = None
        self.last_plane_radiance = None   # (committed diff, spec) (N,P,4)
        self.last_plane_denoised = None   # (P,H,W,3) diff / spec stacks

    def render_frame(self, width: int, height: int,
                     camera: Optional[CameraData] = None,
                     denoise: Optional[bool] = None, taa: bool = True,
                     display_size: Optional[tuple] = None):
        """Render one frame at (width, height); returns linear HDR
        (H,W,3)."""
        if display_size is not None:
            raise NotImplementedError("TAAU (display_size) is not ported "
                                      "yet")
        cam = (camera or self.camera).to(self.device)
        jit = r2_jitter(self.frame_index) if self.cfg.realtime_noise \
            else (0.0, 0.0)
        cam = cam._replace(
            jitter=torch.tensor(jit, dtype=torch.float32, device=self.device),
            viewport=torch.tensor([width, height], dtype=torch.float32,
                                  device=self.device))
        px, py = self._pixel_grid(width, height)
        consts = C.default_constants(sample_base_index=self.frame_index)
        has_prev = self.prev_reservoir is not None
        n = width * height
        z = lambda *s: torch.zeros((n,) + s, dtype=torch.float32,
                                   device=self.device)
        (sp, cdiff, cspec, smot, r_fb, gi_fb, gb_normal, gb_z) = \
            _pt_frame_stable(
                self.assets, cam, self.prev_cam, self.prev_reservoir,
                self.prev_gi, self.prev_gb_normal if has_prev else z(3),
                self.prev_gb_z if has_prev else z(), px, py, consts,
                cfg=self.cfg, width=width, height=height, has_prev=has_prev)
        use_den = self.cfg.denoiser_enabled if denoise is None else denoise
        if self.den_states is None:
            self.den_states = [(None, None)] * self.cfg.stable_plane_count
        (color, self.den_states, self.taa_state,
         self.last_plane_denoised) = _post_frame_stable(
            sp, cdiff, cspec, smot, self.den_states, self.taa_state,
            width=width, height=height, use_den=use_den, use_taa=taa)
        self.last_plane_radiance = (cdiff, cspec)
        self.last_stable_planes = sp
        self.prev_cam = cam
        self.prev_reservoir = r_fb
        self.prev_gi = gi_fb
        self.prev_gb_normal = gb_normal
        self.prev_gb_z = gb_z
        self.frame_index += 1
        return color
