"""Debug visualization: any internal channel as an image (counterpart of
rtxpt_tpu/utils/debugviews.py; the reference's DebugViewType channels,
RTXPT/PathTracer/ShaderDebug.hlsli:24-80, and the pick-pixel readback,
DebugContext::Print :263 and the feedback buffers Sample.cpp:287-358).

The surface views re-trace the G-buffer (pt/gbuffer.trace_gbuffer: the
trace structure's kernel and one surface fetch per segment) and read its
channels; the pipeline views read a realtime renderer's outputs
(`RealtimeRenderer.last_outputs`, `last_stable_planes`,
`last_plane_radiance`, `last_plane_denoised`, `den_states`). Every
tensor a view makes lies on the device of its inputs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import rng
from ..pt import gbuffer as GB
from ..pt import stableplanes as SPM
from ..restir import di
from ..restir import regir as RG

# DebugViewType coverage (ShaderDebug.hlsli:24-80 naming)
VIEWS = [
    "FirstHitBarycentrics", "FirstHitFaceNormal", "FirstHitShadingNormal",
    "FirstHitShadingTangent", "FirstHitShadingBitangent",
    "FirstHitFrontFacing", "FirstHitThinSurface",
    "FirstHitShaderPermutation",
    "FirstHitDiffuse", "FirstHitSpecular", "FirstHitRoughness",
    "FirstHitMetallic", "FirstHitEmissive", "FirstHitOpacity",
    "FirstHitThp", "FirstHitViewDir", "MaterialID", "ViewZ",
    "MotionVectors", "Depth", "ImagePlaneRayLength",
    "VBufferMotionVectors", "VBufferDepth",
    "FirstHitOpacityMicroMapInWorld", "FirstHitOpacityMicroMapOverlay",
    "DenoiserDiffRadiance",
    "DenoiserSpecRadiance", "ReSTIRDIOutput", "ReSTIRGIOutput",
    # ReSTIR DI per-stage outputs (ShaderDebug.hlsli:71-76); Initial and
    # Spatial recompute the stage on the retraced G-buffer, Temporal
    # shades the frame's feedback reservoir (post-temporal, pre-spatial)
    "ReSTIRDIInitialOutput", "ReSTIRDITemporalOutput",
    "ReSTIRDISpatialOutput", "ReSTIRDIFinalContribution",
    "ReGIRIndirectOutput",
    # ReSTIR GI secondary surface (ShaderDebug.hlsli:67-69)
    "SecondarySurfacePosition", "SecondarySurfaceRadiance",
    # stable-planes explorer (StablePlaneDebugVizColor + per-plane data;
    # needs stable_planes= from RealtimeRenderer.last_stable_planes;
    # plane_index=-1 follows the dominant plane, >=0 picks one:
    # the reference's DebugViewStablePlaneIndex, SampleUI.h:192)
    "StablePlaneCount", "StablePlaneDominant", "StablePlaneBranchViz",
    "StablePlaneVirtualDepth", "StableRadiance",
    "StablePlaneNormals", "StablePlaneRoughness",
    "StablePlaneMotionVectors", "StablePlaneViewZ",
    "StablePlaneVirtualRayLength",
    "StablePlaneDiffBSDFEstimate", "StablePlaneSpecBSDFEstimate",
    "StablePlaneDiffRadiance", "StablePlaneSpecRadiance",
    "StablePlaneDiffHitDist", "StablePlaneSpecHitDist",
    "StablePlaneDiffRadianceDenoised", "StablePlaneSpecRadianceDenoised",
    "StablePlaneCombinedRadianceDenoised",
    "StablePlaneRelaxedDisocclusion", "StablePlaneDenoiserValidation",
    # NaN/Inf sanitizer (Sample.hlsl:217-243 cross pattern)
    "NaNSanitizer",
]

# reference names that map onto an existing channel 1:1 (the G-buffer is
# the V-buffer resolve; after PSR they coincide on non-delta surfaces)
_ALIASES = {
    "VBufferMotionVectors": "MotionVectors",
    "VBufferDepth": "Depth",
    "DominantStablePlaneIndex": "StablePlaneDominant",
    # the frame's di_diffuse + di_specular is the final contribution of
    # the fused final-shade pass
    "ReSTIRDIFinalOutput": "ReSTIRDIOutput",
    "ReSTIRDIFinalContribution": "ReSTIRDIOutput",
}

_STABLE_PLANE_RADIANCE = ("StablePlaneDiffRadiance",
                          "StablePlaneSpecRadiance",
                          "StablePlaneDiffHitDist", "StablePlaneSpecHitDist")


def _normalize01(x):
    lo = torch.amin(x)
    hi = torch.amax(x)
    return (x - lo) / torch.clamp(hi - lo, min=1e-9)


def _gray(x):
    """(N,) -> (N,3)."""
    return x[..., None].expand(*x.shape, 3)


def _reinhard(x):
    return torch.clamp(x / (1.0 + x), 0.0, 1.0)


# byte / 255 by float32 division, looked up: a CUDA tensor divided by a
# host scalar is multiplied by its reciprocal, which can round otherwise
_BYTE01 = np.arange(256, dtype=np.float32) / np.float32(255.0)


def _hash_color(key):
    """(N,) integer key -> (N,3) colour of its lowbias32 hash bytes."""
    h = rng.hash32(key.to(torch.int64))
    lut = torch.as_tensor(_BYTE01, device=h.device)
    return torch.stack([lut[h & 255], lut[(h >> 8) & 255],
                        lut[(h >> 16) & 255]], -1)


def _nan_sanitizer(color, shp2):
    img = color.reshape(shp2 + (3,))
    bad = ~torch.isfinite(img).all(-1)
    # dilate into a cross pattern so single pixels are visible
    cross = bad
    for d in range(1, 4):
        cross = cross | torch.roll(bad, d, 0) | torch.roll(bad, -d, 0) \
            | torch.roll(bad, d, 1) | torch.roll(bad, -d, 1)
    mark = torch.tensor([1.0, 0.0, 1.0], device=img.device)
    safe = torch.where(torch.isfinite(img), img, 0.0)
    return torch.where(cross[..., None], mark,
                       torch.clamp(safe / (1.0 + safe), 0.0, 1.0))


def _stable_plane_view(view, sp, plane_index, plane_radiance):
    """(N,3) of a StablePlane* view or StableRadiance."""
    P = sp.count
    valid = sp.branch_id != SPM.INVALID_BRANCH          # (N,P)
    n = valid.shape[0]
    dev = valid.device

    def pick(arr):
        """(N,P,...) -> (N,...) at plane_index (-1 = dominant)."""
        if plane_index >= 0:
            return arr[:, plane_index]
        oh = torch.arange(P, device=dev)[None, :] == sp.dominant[:, None]
        return torch.sum(arr * oh.reshape(oh.shape + (1,) * (arr.dim() - 2)),
                         dim=1)

    pvalid = (valid[:, plane_index] if plane_index >= 0
              else torch.ones(n, dtype=torch.bool, device=dev))
    if view == "StablePlaneCount":
        c = valid.sum(-1).to(torch.float32) / P
        out = torch.stack([c, 1.0 - c, torch.zeros_like(c)], -1)
    elif view == "StablePlaneDominant":
        cols = torch.eye(3, device=dev)
        out = cols[torch.clamp(sp.dominant, 0, 2)]
    elif view == "StablePlaneBranchViz":
        # plane presence as RGB channels (DebugVizColor scheme)
        out = torch.stack(
            [valid[:, p].to(torch.float32) if p < P
             else torch.zeros(n, device=dev) for p in range(3)], -1)
    elif view == "StablePlaneVirtualDepth":
        z = torch.where(valid, sp.scene_length, 0.0).amax(-1)
        out = _gray(_normalize01(z))
    elif view == "StablePlaneNormals":
        out = pick(sp.normal) * 0.5 + 0.5
    elif view == "StablePlaneRoughness":
        out = _gray(pick(sp.roughness))
    elif view == "StablePlaneMotionVectors":
        m = pick(sp.motion)
        out = torch.stack([torch.abs(m[..., 0]), torch.abs(m[..., 1]),
                           torch.zeros_like(m[..., 0])], -1) * 0.1
    elif view == "StablePlaneViewZ":
        out = _gray(_normalize01(pick(sp.view_z)))
    elif view == "StablePlaneVirtualRayLength":
        out = _gray(_normalize01(pick(sp.scene_length)))
    elif view == "StablePlaneDiffBSDFEstimate":
        out = pick(sp.diff_est)
    elif view == "StablePlaneSpecBSDFEstimate":
        out = pick(sp.spec_est)
    elif view in _STABLE_PLANE_RADIANCE:
        if plane_radiance is None:
            raise ValueError(
                f"debug view {view} needs plane_radiance (render a "
                "stable-planes frame first; "
                "RealtimeRenderer.last_plane_radiance)")
        cdiff, cspec = plane_radiance        # (N,P,4)
        src = cdiff if "Diff" in view else cspec
        if view.endswith("HitDist"):
            out = _gray(_normalize01(pick(src[..., 3])))
        else:
            out = _reinhard(pick(src[..., :3]))
    elif view == "StableRadiance":
        out = _reinhard(sp.stable_radiance)
    else:
        raise ValueError(f"unknown debug view {view}; options: {VIEWS}")
    return torch.where(pvalid[..., None], out, 0.0)


def _pipeline_view(view, shp2, frame_outputs, stable_planes, plane_index,
                   plane_radiance, plane_denoised, den_states):
    """(H,W,3) of a view that reads a realtime frame's outputs, or None
    for a view that re-traces the G-buffer."""
    if view in ("StablePlaneDiffRadianceDenoised",
                "StablePlaneSpecRadianceDenoised",
                "StablePlaneCombinedRadianceDenoised"):
        if plane_denoised is None:
            raise ValueError(
                f"debug view {view} needs plane_denoised (render a "
                "denoised stable-planes frame first; "
                "RealtimeRenderer.last_plane_denoised)")
        dstack, sstack = plane_denoised          # (P,H,W,3) each
        p = max(plane_index, 0)
        if view == "StablePlaneDiffRadianceDenoised":
            out = dstack[p]
        elif view == "StablePlaneSpecRadianceDenoised":
            out = sstack[p]
        else:
            out = dstack[p] + sstack[p]
        return _reinhard(out)
    if view in ("StablePlaneRelaxedDisocclusion",
                "StablePlaneDenoiserValidation"):
        if not den_states or den_states[0][0] is None:
            raise ValueError(
                f"debug view {view} needs den_states (render a denoised "
                "realtime frame first; RealtimeRenderer.den_states)")
        dd, ds = den_states[max(plane_index, 0)]
        if view == "StablePlaneRelaxedDisocclusion":
            # fresh history (disocclusion / clamp reset) in red, settled
            # history in green: the NRD validation overlay scheme
            relax = torch.clamp(2.0 - dd.history, 0.0, 1.0)
            out = torch.stack([relax, 1.0 - relax, torch.zeros_like(relax)],
                              -1)
        else:
            h = torch.clamp(dd.history / 32.0, max=1.0)
            hs = torch.clamp(ds.history / 32.0, max=1.0)
            out = torch.stack([1.0 - h, h * hs, 1.0 - hs], -1)
        return torch.clamp(out, 0.0, 1.0)
    if view.startswith("StablePlane") or view == "StableRadiance":
        if stable_planes is None:
            raise ValueError(
                f"debug view {view} needs stable_planes (render a "
                "stable-planes realtime frame first)")
        out = _stable_plane_view(view, stable_planes, plane_index,
                                 plane_radiance)
        return torch.clamp(out.reshape(shp2 + (3,)), 0.0, 1.0)
    if view in ("SecondarySurfacePosition", "SecondarySurfaceRadiance"):
        if frame_outputs is None:
            raise ValueError(f"debug view {view} needs frame_outputs")
        gr = frame_outputs.gi_reservoir
        if view == "SecondarySurfacePosition":
            out = torch.where(gr.valid[..., None], _normalize01(gr.pos), 0.0)
        else:
            out = torch.where(gr.valid[..., None],
                              gr.radiance / (1.0 + gr.radiance), 0.0)
        return torch.clamp(out.reshape(shp2 + (3,)), 0.0, 1.0)
    if view in ("DenoiserDiffRadiance", "DenoiserSpecRadiance",
                "ReSTIRDIOutput", "ReSTIRGIOutput"):
        if frame_outputs is None:
            raise ValueError(
                f"debug view {view} needs frame_outputs (render a "
                "realtime frame first; RealtimeRenderer.last_outputs)")
        fo = frame_outputs
        if view == "DenoiserDiffRadiance":
            out = fo.di_diffuse + fo.indirect_diffuse
        elif view == "DenoiserSpecRadiance":
            out = fo.di_specular + fo.indirect_specular
        elif view == "ReSTIRDIOutput":
            out = fo.di_diffuse + fo.di_specular
        else:  # ReSTIRGIOutput
            out = fo.indirect_diffuse + fo.indirect_specular
        return _reinhard(out.reshape(shp2 + (3,)))
    return None


def _restir_view(view, assets, gb, px, py, width, height, frame_outputs,
                 frame_index):
    """(N,3) of a ReSTIR DI stage view or ReGIRIndirectOutput on the
    re-traced G-buffer."""
    if view == "ReGIRIndirectOutput":
        # one unshadowed ReGIR draw at the primary surface: the local-light
        # grid's output field (LightSamplingLocal.hlsli ReGIR debug)
        grid = assets.regir
        if grid is None:
            if assets.lights is None:
                raise ValueError("ReGIRIndirectOutput needs local lights "
                                 "(assets.lights)")
            pos = assets.scene.positions
            grid = RG.build_regir(assets.lights, pos.amin(0) - 1e-3,
                                  pos.amax(0) + 1e-3, frame_index)
        g = rng.make(px, py, 0, frame_index)
        g, u2 = rng.next_2d(g)
        ls = RG.sample_regir(grid, assets.lights, gb.pos, u2)
        nol = torch.clamp(torch.sum(gb.normal * ls.direction, -1), min=0.0)
        out = torch.where((gb.valid & ls.valid)[..., None],
                          ls.li * nol[..., None], 0.0)
        out = out / (1.0 + out)
    else:
        if view == "ReSTIRDIInitialOutput":
            r = di.generate_candidates(assets, gb, px, py, frame_index)
        elif view == "ReSTIRDITemporalOutput":
            if frame_outputs is None:
                raise ValueError(f"{view} needs frame_outputs (the "
                                 "feedback reservoir is post-temporal)")
            r = frame_outputs.reservoir
        elif view == "ReSTIRDISpatialOutput":
            base = (frame_outputs.reservoir if frame_outputs is not None
                    else di.generate_candidates(assets, gb, px, py,
                                                frame_index))
            r = di.spatial_resample(assets, gb, base, px, py, width, height,
                                    frame_index)
        else:
            raise ValueError(f"unknown debug view {view}")
        d, s = di.final_shade(assets, gb, r)
        out = d + s
        out = out / (1.0 + out)
    return torch.clamp(torch.where(gb.valid[..., None], out, 0.0), 0.0, 1.0)


def _surface_view(view, assets, gb):
    """(N,3) of a first-hit channel of the G-buffer `gb`."""
    sd = gb.surface.sd
    if view == "FirstHitBarycentrics":
        b = gb.bary
        return torch.stack([b[..., 0], b[..., 1], 1.0 - b[..., 0] - b[..., 1]],
                           -1)
    if view == "FirstHitFaceNormal":
        return gb.face_normal * 0.5 + 0.5
    if view == "FirstHitShadingNormal":
        return gb.normal * 0.5 + 0.5
    if view == "FirstHitDiffuse":
        return gb.diffuse_albedo
    if view == "FirstHitSpecular":
        return gb.specular_albedo
    if view == "FirstHitRoughness":
        return _gray(gb.roughness)
    if view == "FirstHitMetallic":
        return _gray(gb.surface.bsdf_data.metallic)
    if view == "FirstHitEmissive":
        return gb.emission
    if view == "FirstHitOpacity":
        return _gray(sd.opacity)
    if view == "FirstHitThp":
        return gb.psr_thp
    if view == "FirstHitViewDir":
        return gb.view_dir * 0.5 + 0.5
    if view == "FirstHitShadingTangent":
        return sd.t * 0.5 + 0.5
    if view == "FirstHitShadingBitangent":
        return sd.b * 0.5 + 0.5
    if view == "FirstHitFrontFacing":
        ff = sd.front_facing.to(torch.float32)
        return torch.stack([1.0 - ff, ff, torch.zeros_like(ff)], -1)
    if view == "FirstHitThinSurface":
        return _gray(sd.thin_surface.to(torch.float32))
    if view == "FirstHitShaderPermutation":
        # colour by static shading class: the counterpart of the
        # reference's shader permutation id
        bd = gb.surface.bsdf_data
        key = ((bd.metallic > 0.5).to(torch.int64)
               | ((bd.specular_transmission > 0.0).to(torch.int64) << 1)
               | (sd.thin_surface.to(torch.int64) << 2)
               | (gb.surface.alpha_mode.to(torch.int64) << 3))
        return _hash_color(key)
    if view == "ImagePlaneRayLength":
        return _gray(_normalize01(torch.where(gb.valid, gb.t, 0.0)))
    if view in ("FirstHitOpacityMicroMapInWorld",
                "FirstHitOpacityMicroMapOverlay"):
        return _omm_view(assets, gb, overlay=view.endswith("Overlay"))
    if view == "MaterialID":
        return _hash_color(sd.material_id)
    if view in ("ViewZ", "Depth"):
        return _gray(_normalize01(torch.where(gb.valid, gb.view_z, 0.0)))
    if view == "MotionVectors":
        m = gb.motion
        return torch.stack([torch.abs(m[..., 0]), torch.abs(m[..., 1]),
                            torch.zeros_like(m[..., 0])], -1) * 0.1
    raise ValueError(f"unknown debug view {view}; options: {VIEWS}")


def _pixel_grid(width: int, height: int, device):
    yy, xx = np.mgrid[0:height, 0:width]
    t = lambda a: torch.as_tensor(a.reshape(-1).astype(np.int64),
                                  device=device)
    return t(xx), t(yy)


def render_debug_view(view: str, assets, cam, width: int, height: int,
                      frame_outputs=None, stable_planes=None,
                      color=None, plane_index: int = -1,
                      plane_radiance=None, plane_denoised=None,
                      den_states=None, frame_index: int = 0):
    """Render one debug channel to (H,W,3) in [0, 1].

    Pipeline-output views (Denoiser*, ReSTIRDIOutput, ReSTIRGIOutput,
    Secondary*) read `frame_outputs` (a models.realtime.FrameOutputs,
    RealtimeRenderer.last_outputs of a PSR-lite frame); StablePlane*
    views read `stable_planes` (RealtimeRenderer.last_stable_planes);
    the per-plane radiance views read `plane_radiance` (the (N,P,4)
    committed diff / spec pair, .last_plane_radiance) and
    `plane_denoised` ((P,H,W,3) stacks, .last_plane_denoised); the
    denoiser-history views read `den_states` (per plane (diff, spec)
    states, .den_states); `plane_index` selects the stable plane (-1 =
    dominant). NaNSanitizer paints the non-finite pixels of `color` with
    the reference's cross pattern. The surface and ReSTIR stage views
    re-trace the G-buffer on `assets` with `cam` (whose viewport is
    (width, height)), on the device of the assets' tables."""
    view = _ALIASES.get(view, view)
    shp2 = (height, width)
    if view == "NaNSanitizer":
        if color is None:
            raise ValueError("NaNSanitizer needs color=")
        return _nan_sanitizer(color, shp2)
    out = _pipeline_view(view, shp2, frame_outputs, stable_planes,
                         plane_index, plane_radiance, plane_denoised,
                         den_states)
    if out is not None:
        return out
    if view not in VIEWS:
        raise ValueError(f"unknown debug view {view}; options: {VIEWS}")
    px, py = _pixel_grid(width, height, assets.scene.positions.device)
    gb = GB.trace_gbuffer(assets, cam, cam, px, py)
    if view.startswith("ReSTIRDI") or view == "ReGIRIndirectOutput":
        out = _restir_view(view, assets, gb, px, py, width, height,
                           frame_outputs, frame_index)
        return out.reshape(shp2 + (3,))
    out = torch.where(gb.valid[..., None], _surface_view(view, assets, gb),
                      0.0)
    return torch.clamp(out, 0.0, 1.0).reshape(shp2 + (3,))


def _omm_view(assets, gb, overlay: bool):
    """Opacity micro-mask state at the first hit: green = opaque cell,
    red = transparent cell, gray = the triangle carries no mask
    (FirstHitOpacityMicroMapInWorld / ...Overlay, ShaderDebug.hlsli:
    64-65). The masks are the renderer's bake by triangle
    (`RenderAssets.tri_omm`; the reference reads its BVH2's leaves).
    Overlay blends with the surface albedo."""
    n = gb.valid.shape[0]
    dev = gb.valid.device
    if assets.tri_omm is None:
        return torch.tensor([[0.25, 0.25, 0.3]], device=dev).expand(n, 3)
    pm = assets.tri_omm
    mask = pm[torch.clamp(gb.prim, 0, pm.shape[0] - 1).long()]
    has = (mask != 0xFFFF) & gb.valid
    ci = torch.clamp((gb.bary[..., 0] * 4.0).to(torch.int32), 0, 3)
    cj = torch.clamp((gb.bary[..., 1] * 4.0).to(torch.int32), 0, 3)
    bit = ((mask >> (ci * 4 + cj)) & 1) != 0
    green = torch.tensor([0.1, 0.85, 0.1], device=dev)
    red = torch.tensor([0.9, 0.08, 0.08], device=dev)
    gray = torch.tensor([0.3, 0.3, 0.35], device=dev)
    out = torch.where(has[..., None],
                      torch.where(bit[..., None], green, red), gray)
    if overlay:
        out = 0.55 * gb.diffuse_albedo + 0.45 * out
    return torch.where(gb.valid[..., None], out, 0.0)


def inspect_pixel(assets, cam, width: int, height: int, x: int, y: int
                  ) -> Dict:
    """Per-pixel pick readback (the reference's pick-pixel feedback
    struct, Sample.cpp:2207-2225): a 1-lane G-buffer trace, read back in
    one copy to the host."""
    dev = assets.scene.positions.device
    px = torch.tensor([x], dtype=torch.int64, device=dev)
    py = torch.tensor([y], dtype=torch.int64, device=dev)
    gb = GB.trace_gbuffer(assets, cam, cam, px, py)
    sd = gb.surface.sd
    row = torch.cat([gb.valid.to(torch.float32), gb.t, gb.pos[0],
                     gb.normal[0], gb.roughness, gb.diffuse_albedo[0],
                     gb.view_z]).cpu().numpy()
    ints = torch.stack([gb.prim[0].to(torch.int64),
                        sd.material_id[0].to(torch.int64)]).cpu().numpy()
    return dict(
        valid=bool(row[0]),
        prim=int(ints[0]),
        t=float(row[1]),
        position=row[2:5].tolist(),
        normal=row[5:8].tolist(),
        material_id=int(ints[1]),
        roughness=float(row[8]),
        diffuse_albedo=row[9:12].tolist(),
        view_z=float(row[12]),
    )
