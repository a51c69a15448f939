"""The realtime frame of the stable-planes pipeline (counterpart of the
port's models/realtime.py `_pt_frame_stable`, `_post_frame_stable`,
`dominant_gbuffer` and `RealtimeRenderer._frame`), in two stages:

- `path_stage`, at any set of pixels: BUILD -> ReSTIR DI (presample,
  candidates, temporal, spatial) -> FILL -> ReSTIR GI (initial, temporal,
  spatial) -> the fused DI + GI final shading -> the fold of that
  radiance into the dominant plane's channels;
- `image_stage`, on the whole frame: the specular virtual motion, ReLAX
  per plane and channel, the compose and TAA.

The cross-pixel reads of the path stage come from a `Source`: with
`own_source` every pixel of the frame is replayed and the reads take the
replay's own results, as the program takes its own; a check that replays
only drawn pixels hands in a source built from the program's full-frame
buffers (benchmark/benchlib/check_rt.py), so that each drawn pixel is
computed from the same neighbours the program used, and is held to the
program's value at that pixel.

`render_frame` chains the two stages over the whole frame, with the
history a `History` carries from frame to frame, as the port's
RealtimeRenderer does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import PTConstants
from ..ops import traverse
from ..ops.intersect import Hit
from ..pt import shading
from ..pt.integrator import RenderAssets
from ..scene import build as RB
from ..scene import camera as RCAM
from ..scene import envmap as REM
from ..scene import lights as RL
from ..scene import textures as RTX
from . import denoise as DN
from . import fill as F
from . import restir as RS
from . import stableplanes as SPM
from .config import RTConfig
from .extra import GBuffer, project_to_screen


def r2_jitter(index: int):
    """R2 low-discrepancy AA jitter in [-0.5, 0.5)^2."""
    a1, a2 = 0.7548776662466927, 0.5698402909980532
    return (((0.5 + a1 * index) % 1.0) - 0.5,
            ((0.5 + a2 * index) % 1.0) - 0.5)


def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def make_assets(host: dict, env_radiance, device,
                control: bool = False) -> RenderAssets:
    """The reference's own scene tables and brute-force clusters. control:
    the scene's geometry, the environment and every ray and hit through
    the trace rounded to bfloat16 (the check's control)."""
    if control:
        host = dict(host)
        for key in ("positions", "normals", "tangents", "uvs"):
            host[key] = _bf16(host[key])
        env_radiance = _bf16(env_radiance)
    env = REM.make_envmap(env_radiance, device=device)
    lights = RL.build_light_table(host, device=device)
    accel = traverse.build_clusters(host["positions"], host["indices"],
                                    device)
    if control:
        accel.round_to = torch.bfloat16
    scene = RB.to_device(host, device, RTX.build_texture_stack(
        host.get("texture_images"), srgb=host.get("texture_srgb"),
        device=device))
    return RenderAssets(scene=scene, env=env, lights=lights, accel=accel)


def view_camera(width: int, height: int, eye, target, fov_y: float,
                frame_index: Optional[int], device):
    """The camera of one frame: look_at, with the frame's R2 jitter (none
    for frame_index None, the renderer's construction camera)."""
    cam = RCAM.look_at(width, height, eye, target, fov_y=fov_y)
    if frame_index is not None:
        cam = cam._replace(jitter=torch.tensor(r2_jitter(frame_index),
                                               dtype=torch.float32))
    return cam.to(device)


@dataclasses.dataclass
class History:
    """What one frame hands the next (the renderer's temporal state)."""
    prev_cam: object                   # refpt CameraData
    frame_index: int = 0
    di: Optional[RS.Reservoir] = None  # full-frame DI feedback
    gi: Optional[RS.GIReservoir] = None
    gb_normal: Optional[torch.Tensor] = None   # (H*W,3)
    gb_z: Optional[torch.Tensor] = None        # (H*W,)
    den_states: Optional[list] = None  # per plane (diffuse, specular)
    taa: Optional[DN.TAAState] = None


def _dsel(arr, dom):
    """arr[i, dom[i]] of an (N, P, ...) array."""
    idx = dom.reshape((-1,) + (1,) * (arr.dim() - 1))
    idx = idx.expand((-1, 1) + tuple(arr.shape[2:]))
    return torch.gather(arr, 1, idx)[:, 0]


def dominant_gbuffer(assets, sp: SPM.StablePlanes) -> GBuffer:
    """The dominant plane's G-buffer."""
    dom = sp.dominant
    d_prim = _dsel(sp.prim, dom)
    d_bary = _dsel(sp.bary, dom)
    d_dir = _dsel(sp.ray_dir, dom)
    surf_d = shading.load_surface(assets.scene, d_prim, d_bary, d_dir)
    return GBuffer(
        valid=d_prim >= 0, prim=d_prim, bary=d_bary,
        t=_dsel(sp.scene_length, dom), pos=surf_d.sd.pos,
        normal=surf_d.sd.n, face_normal=surf_d.sd.face_n,
        view_z=_dsel(sp.view_z, dom), roughness=_dsel(sp.roughness, dom),
        diffuse_albedo=_dsel(sp.diff_est, dom),
        specular_albedo=_dsel(sp.spec_est, dom),
        emission=torch.zeros_like(surf_d.sd.pos),
        motion=_dsel(sp.motion, dom), view_dir=d_dir,
        psr_thp=_dsel(sp.thp, dom),
        interior=_dsel(sp.interior, dom), surface=surf_d)


def take(tup, idx):
    """A NamedTuple of per-pixel arrays at rows `idx`."""
    return type(tup)(*(a[idx] for a in tup))


class Source(NamedTuple):
    """The cross-pixel reads of `path_stage`.

    di_values(pixels), gi_values(pixels): each pixel's value of the
    boiling filter (expected radiance of the temporal reservoir before
    the filter); di_rows(flat), gi_rows(flat): the neighbour rows of the
    spatial passes (restir.di_neighbour_rows, gi_neighbour_rows)."""
    di_values: Callable
    gi_values: Callable
    di_rows: Callable
    gi_rows: Callable


class PathResult(NamedTuple):
    planes: SPM.StablePlanes
    di_initial: RS.Reservoir
    di_feedback: RS.Reservoir
    gi_initial: RS.GIReservoir
    gi_feedback: RS.GIReservoir
    committed_diff: torch.Tensor      # (N,P,4)
    committed_spec: torch.Tensor      # (N,P,4)
    gb: GBuffer


def _block_pixels(px, py, width: int, height: int):
    """Flat indices of every frame pixel of the 16x16 blocks that hold
    (px, py)."""
    bs = RS.BOIL_BLOCK
    blocks = torch.unique(RS.block_index(px, py, width))
    bw = (width + bs - 1) // bs
    oy, ox = torch.meshgrid(torch.arange(bs, device=px.device),
                            torch.arange(bs, device=px.device),
                            indexing="ij")
    ys = ((blocks // bw) * bs)[:, None] + oy.reshape(1, -1)
    xs = ((blocks % bw) * bs)[:, None] + ox.reshape(1, -1)
    inside = (ys < height) & (xs < width)
    return (ys * width + xs)[inside]


def _boiled(values, src_values, px, py, width: int, height: int):
    """The boiling decision at (px, py): the block means hold `values` at
    these pixels and `src_values(flat)` at the other pixels of their
    blocks (the port's boiling_filter: the frame zero-padded to whole
    16x16 blocks)."""
    bs = RS.BOIL_BLOCK
    blk = _block_pixels(px, py, width, height)
    img = torch.zeros((-(-height // bs) * bs, -(-width // bs) * bs),
                      dtype=values.dtype, device=values.device)
    img[blk // width, blk % width] = src_values(blk)
    img[py, px] = values
    means = img.reshape(img.shape[0] // bs, bs, img.shape[1] // bs,
                        bs).mean(dim=(1, 3)).reshape(-1)
    return RS.boiling(values, means, px, py, width)


def path_stage(assets, cfg: RTConfig, cam, hist: History, pixels,
               width: int, height: int,
               source: Optional[Callable] = None) -> PathResult:
    """Stage 1 of the frame at the flat pixel indices `pixels`; `source`
    is a function (this frame's own PathResult -> Source) that gives the
    cross-pixel reads: None for own_source, which needs every pixel of
    the frame."""
    px, py = pixels % width, pixels // width
    n = px.shape[0]
    dev = px.device
    P = cfg.stable_plane_count
    frame = int(hist.frame_index)
    consts = PTConstants(sample_base_index=frame)
    has_prev = hist.di is not None
    sp = SPM.build_stable_planes(
        assets, cam, hist.prev_cam, px, py, plane_count=P,
        max_vertex_depth=cfg.max_stable_plane_vertex_depth)
    dom = sp.dominant
    gb = dominant_gbuffer(assets, sp)

    # ReSTIR DI: the temporal output, not the spatial one, feeds the next
    # frame
    ris = RS.presample_lights(assets, frame)
    di0 = RS.di_candidates(assets, gb, px, py, frame, ris)
    partial = dict(planes=sp, gb=gb, di_initial=di0)
    if has_prev:
        di_t = RS.di_temporal(assets, gb, di0, hist.di, hist.gb_normal,
                              hist.gb_z, px, py, width, height, frame)
        partial["di_temporal"] = di_t
    # FILL from the plane-0 base
    path0 = F.initial_state(sp, cam, px, py, P)
    injected = Hit(t=sp.scene_length[:, 0], prim=sp.prim[:, 0],
                   bary=sp.bary[:, 0])
    fill = F.render_fill(assets, cam, path0, injected, consts, cfg)
    sec_pos, sec_nrm, sec_found = fill["first"]
    lo = fill["gi_l"] / torch.clamp(fill["gi_thp"], min=1e-6)
    gi0 = RS.gi_initial(gb, sec_pos, sec_nrm, fill["gi_valid"] & sec_found,
                        lo, fill["gi_pdf"])
    partial["gi_initial"] = gi0
    if has_prev:
        gi_t = RS.gi_temporal(gb, gi0, hist.gi, hist.gb_normal, hist.gb_z,
                              px, py, width, height, frame)
        partial["gi_temporal"] = gi_t
    src = (own_source if source is None else source)(
        assets, cfg, cam, hist, width, height, partial)
    if has_prev:
        v = RS.di_boil_value(di_t)
        di_fb = RS.boil_di(di_t, _boiled(v, src.di_values, px, py, width,
                                         height))
        v = RS.gi_boil_value(gi_t)
        gi_fb = RS.boil_gi(gi_t, _boiled(v, src.gi_values, px, py, width,
                                         height))
    else:
        di_fb, gi_fb = di0, gi0
    partial.update(di_feedback=di_fb, gi_feedback=gi_fb)
    r = RS.di_spatial(assets, gb, di_fb, px, py, width, height, frame,
                      lambda f: src.di_rows(f, partial))
    gr = RS.gi_spatial(gb, gi_fb, px, py, width, height, frame,
                       lambda f: src.gi_rows(f, partial))
    di_d, di_s, gi_d, gi_s = RS.fused_final_shade(assets, gb, r, gr)

    # fold the ReSTIR DI + GI radiance at the dominant base (weighted by
    # the plane throughput) into the dominant plane's channels
    dom_oh = (torch.arange(P, device=dev)[None, :] == dom[:, None])[..., None]
    thp_dom = _dsel(sp.thp, dom)
    hit_td = _dsel(sp.view_z, dom)[:, None]

    def fold(chan, add):
        add = (add * thp_dom)[:, None] * torch.ones((1, P, 1), device=dev)
        return torch.where(dom_oh, SPM.combine_hit_t(chan, add, hit_td), chan)

    return PathResult(
        planes=sp, di_initial=di0, di_feedback=di_fb, gi_initial=gi0,
        gi_feedback=gi_fb,
        committed_diff=fold(fill["committed_diff"], di_d + gi_d),
        committed_spec=fold(fill["committed_spec"], di_s + gi_s), gb=gb)


def own_source(assets, cfg, cam, hist, width, height, partial) -> Source:
    """The cross-pixel reads from the replay's own results, which must
    cover every pixel of the frame in order."""
    n = partial["planes"].dominant.shape[0]
    if n != width * height:
        raise ValueError("own_source needs every pixel of the frame")
    cache = {}

    def rows(name, f, part):
        if name not in cache:
            cache[name] = (RS.di_neighbour_rows(part["di_feedback"],
                                                RS.pack_surface(part["gb"]))
                           if name == "di" else
                           RS.gi_neighbour_rows(part["gi_feedback"],
                                                part["gb"]))
        return cache[name][f]

    return Source(
        di_values=lambda f: RS.di_boil_value(partial["di_temporal"])[f],
        gi_values=lambda f: RS.gi_boil_value(partial["gi_temporal"])[f],
        di_rows=lambda f, part: rows("di", f, part),
        gi_rows=lambda f, part: rows("gi", f, part))


def spec_motion(sp: SPM.StablePlanes, committed_spec, prev_cam, width: int,
                height: int):
    """hitT-based virtual reprojection of specular (NRD virtual motion)
    over the whole frame."""
    dev = sp.pos.device
    flat = torch.arange(width * height, device=dev)
    px, py = flat % width, flat // width
    spec_hit_t = committed_spec[..., 3]
    virt_pos = sp.pos + sp.ray_dir * spec_hit_t[..., None]
    prev_xy_virt, _ = project_to_screen(prev_cam, virt_pos)
    cur_xy = torch.stack([px.to(torch.float32), py.to(torch.float32)],
                         -1)[:, None, :]
    w_virt = torch.clamp(1.0 - sp.roughness * 4.0, 0.0, 1.0) * \
        (spec_hit_t > 0.0)
    return sp.motion + (prev_xy_virt - cur_xy - sp.motion) \
        * w_virt[..., None]


def dominant_motion(sp: SPM.StablePlanes, height: int, width: int):
    dom_oh = (torch.arange(sp.branch_id.shape[1], device=sp.motion.device)
              [None, :] == sp.dominant[:, None])
    return torch.sum(sp.motion * dom_oh[..., None], dim=1).reshape(
        height, width, 2)


def image_stage(sp: SPM.StablePlanes, committed_diff, committed_spec,
                hist: History, width: int, height: int):
    """Stage 2 on the whole frame: per plane demodulate -> ReLAX ->
    remodulate -> merge with the stable radiance -> TAA. Returns (colour,
    denoiser states, TAA state, (diffuse, specular) (P,H,W,3) stacks)."""
    smot = spec_motion(sp, committed_spec, hist.prev_cam, width, height)
    P = committed_diff.shape[1]
    shp = (height, width)
    eps = 1e-3
    den_states = hist.den_states or [(None, None)] * P
    color = sp.stable_radiance.reshape(shp + (3,))
    new_den, plane_diff, plane_spec = [], [], []
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
        dd, ds = den_states[p]
        d_f, dd = DN.denoise(dd, d_in, normal, view_z,
                             sp.motion[:, p].reshape(shp + (2,)))
        s_f, ds = DN.denoise(ds, s_in, normal, view_z,
                             smot[:, p].reshape(shp + (2,)),
                             roughness=sp.roughness[:, p].reshape(shp),
                             iterations=3)
        new_den.append((dd, ds))
        pd = torch.where(valid, d_f * diff_est, 0.0)
        ps = torch.where(valid, s_f * spec_est, 0.0)
        plane_diff.append(pd)
        plane_spec.append(ps)
        color = color + pd + ps
    relax_mask = torch.clamp(2.0 - new_den[0][0].history, 0.0, 1.0)
    color, taa = DN.resolve(hist.taa, color, dominant_motion(sp, height,
                                                             width),
                            relax_mask=relax_mask)
    return color, new_den, taa, (torch.stack(plane_diff),
                                 torch.stack(plane_spec))


def render_frame(assets, cfg: RTConfig, cam, hist: History, width: int,
                 height: int):
    """One whole frame: (linear HDR (H,W,3), the next frame's History,
    the PathResult, the (diffuse, specular) denoised stacks)."""
    dev = cam.pos.device
    pixels = torch.arange(width * height, device=dev)
    res = path_stage(assets, cfg, cam, hist, pixels, width, height)
    color, den, taa, stacks = image_stage(
        res.planes, res.committed_diff, res.committed_spec, hist, width,
        height)
    nxt = History(prev_cam=cam, frame_index=hist.frame_index + 1,
                  di=res.di_feedback, gi=res.gi_feedback,
                  gb_normal=res.gb.normal, gb_z=res.gb.view_z,
                  den_states=den, taa=taa)
    return color, nxt, res, stacks
