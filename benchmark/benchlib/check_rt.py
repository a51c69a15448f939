"""The check that decides `correct` in realtime mode, on one frame: the
check frame, rendered by the program after the window on the state the
window left.

Before that frame the harness keeps the program's temporal state (the
previous frame's DI and GI feedback reservoirs, G-buffer normal and
depth, the per-plane denoiser states, the TAA history and the frame
index: `snapshot`); after it, what the program exposes of the frame
(`outputs`): the stable planes, the initial and feedback DI and GI
reservoirs, each plane's committed diffuse and specular radiance, the
denoised stacks and the returned image.

The plain reference (`refpt.realtime`) then replays the frame from the
snapshot, teacher-forced:

- the path stages (BUILD, ReSTIR DI, FILL, ReSTIR GI, the final shading
  and its fold into the planes) at pixels drawn from the seed; their
  cross-pixel reads (the boiling filter's block means, the spatial taps)
  take the program's own full-frame buffers, which are themselves held
  at the drawn pixels;
- the image stages (ReLAX per plane and channel, the compose, TAA) on the
  whole frame, from the program's committed radiance and planes.

Each quantity is compared per pixel under the reference cells' rule (a
channel off by more than 1e-3 of the reference's value + 1e-5, or an
integer field unequal; the planes' motion and barycentrics with an
absolute term of their own, `_ATOLS`), and its share of pixels off is
limited. A
reservoir whose choice flipped (its light, or its GI sample's validity or
position, differs) is counted apart, and its share limited too. The
frame counter must equal the frames rendered.

The control: the same replay with the scene's geometry, the environment
and every ray and hit through the trace rounded to bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from refpt.realtime import frame as RF
from refpt.realtime import restir as RS
from refpt.realtime import stableplanes as SPM
from refpt.realtime.config import RTConfig
from refpt.realtime.denoise import DenoiserState, TAAState

RTOL = 1e-3
ATOL = 1e-5
QUANTITIES = ("planes", "di_initial", "di_feedback", "gi_initial",
              "gi_feedback", "radiance", "denoised", "image")
LIMITS = dict({f"{q}_off_share": 0.02 for q in QUANTITIES},
              di_flip_share=0.02, gi_flip_share=0.02, frame_index_off=0)
# integer fields, compared for equality
_INTS = {"branch_id", "vertex_index", "prim", "interior", "dominant",
         "light", "valid"}
# fields with an absolute tolerance of their own in place of ATOL: the
# screen-space motion (px), a difference of two screen positions, and the
# hit's barycentrics, solved from world coordinates of ~100 units. Two
# sound float32 evaluations (the program's BVH8 kernel and the
# reference's brute-force trace) part by up to 0.040 px and 4.6e-4 in
# them at all but rare pixels; the bfloat16 control by 10-26 px and
# 0.36-0.87 (PERF.md §6).
_ATOLS = {"motion": 0.05, "bary": 1e-3}


def as_type(cls, x):
    """`x`, a NamedTuple with the fields of `cls`, as a `cls`."""
    return cls(**{f: getattr(x, f) for f in cls._fields})


def snapshot(renderer) -> dict:
    """Copies of the program's temporal state before a frame."""
    c = lambda t: None if t is None else t.clone()
    den = renderer.den_states
    return dict(
        frame_index=int(renderer.frame_index),
        di=None if renderer.prev_reservoir is None else
        as_type(RS.Reservoir, type(renderer.prev_reservoir)(
            *map(c, renderer.prev_reservoir))),
        gi=None if renderer.prev_gi is None else
        as_type(RS.GIReservoir, type(renderer.prev_gi)(
            *map(c, renderer.prev_gi))),
        gb_normal=c(renderer.prev_gb_normal), gb_z=c(renderer.prev_gb_z),
        den_states=None if den is None else [
            tuple(None if s is None else DenoiserState(*map(c, as_type(
                DenoiserState, s))) for s in pair) for pair in den],
        taa=None if renderer.taa_state is None else TAAState(
            history=renderer.taa_state.history.clone(),
            valid=bool(renderer.taa_state.valid)))


def outputs(renderer, image, rendered: int) -> dict:
    """What the program exposes of the frame it has just rendered, the
    `rendered`-th frame of its life."""
    di0, gi0 = renderer.last_restir_initial
    cdiff, cspec = renderer.last_plane_radiance
    dstack, sstack = renderer.last_plane_denoised
    return dict(
        planes=as_type(SPM.StablePlanes, renderer.last_stable_planes),
        di_initial=as_type(RS.Reservoir, di0),
        gi_initial=as_type(RS.GIReservoir, gi0),
        di_feedback=as_type(RS.Reservoir, renderer.prev_reservoir),
        gi_feedback=as_type(RS.GIReservoir, renderer.prev_gi),
        committed_diff=cdiff, committed_spec=cspec, denoised_diff=dstack,
        denoised_spec=sstack, image=image,
        frame_index=int(renderer.frame_index), frames_rendered=rendered)


def _off(p, r, atol: float = ATOL):
    """(N,) True where a row of p is off from the reference row r."""
    p = p.to(torch.float64).reshape(p.shape[0], -1)
    r = r.to(torch.float64).reshape(r.shape[0], -1)
    return ((p - r).abs() > RTOL * r.abs() + atol).any(-1) | \
        ~torch.isfinite(p).all(-1)


def _off_fields(prog, ref) -> dict:
    """Per field of a NamedTuple, (N,) True where the program's row is
    off from the reference's."""
    return {name: (getattr(prog, name) != getattr(ref, name)).reshape(
        getattr(ref, name).shape[0], -1).any(-1) if name in _INTS else
        _off(getattr(prog, name), getattr(ref, name),
             _ATOLS.get(name, ATOL)) for name in ref._fields}


def _any(masks) -> torch.Tensor:
    out = None
    for m in masks:
        out = m if out is None else out | m
    return out


def _teacher(out: dict):
    """The cross-pixel reads of the path stage from the program's
    full-frame buffers."""
    planes = out["planes"]

    def source(assets, cfg, cam, hist, width, height, partial):
        gb_at = lambda f: RF.dominant_gbuffer(assets, RF.take(planes, f))

        def di_values(f):
            px, py = f % width, f // width
            t = RS.di_temporal(assets, gb_at(f), RF.take(out["di_initial"],
                                                          f),
                               hist.di, hist.gb_normal, hist.gb_z, px, py,
                               width, height, hist.frame_index)
            return RS.di_boil_value(t)

        def gi_values(f):
            px, py = f % width, f // width
            t = RS.gi_temporal(gb_at(f), RF.take(out["gi_initial"], f),
                               hist.gi, hist.gb_normal, hist.gb_z, px, py,
                               width, height, hist.frame_index)
            return RS.gi_boil_value(t)

        return RF.Source(
            di_values=di_values, gi_values=gi_values,
            di_rows=lambda f, part: RS.di_neighbour_rows(
                RF.take(out["di_feedback"], f),
                RS.pack_surface(gb_at(f))),
            gi_rows=lambda f, part: RS.gi_neighbour_rows(
                RF.take(out["gi_feedback"], f), gb_at(f)))
    return source


def replay(host: dict, env_radiance, settings: dict, width: int,
           height: int, cam_args, snap: dict, out: dict, pixels, device,
           control: bool = False) -> dict:
    """Replay the check frame and compare it with the program's. cam_args
    = (eye, prev_eye, target, fov_y): the frame's view and the previous
    one's. Returns the numbers (the compared ones and the reference's
    images for a caller)."""
    cfg = RTConfig(**settings).check()
    eye, prev_eye, target, fov_y = cam_args
    # the frame's index by the frames rendered, not by the program's counter
    fi = out["frames_rendered"] - 1
    assets = RF.make_assets(host, env_radiance, device, control=control)
    cam = RF.view_camera(width, height, eye, target, fov_y, fi, device)
    prev_cam = RF.view_camera(width, height, prev_eye, target, fov_y,
                              fi - 1 if fi > 0 else None, device)
    hist = RF.History(prev_cam=prev_cam, frame_index=fi, di=snap["di"],
                      gi=snap["gi"], gb_normal=snap["gb_normal"],
                      gb_z=snap["gb_z"], den_states=snap["den_states"],
                      taa=snap["taa"])
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=device)
    res = RF.path_stage(assets, cfg, cam, hist, pix, width, height,
                        source=_teacher(out))
    color, _, _, (dstack, sstack) = RF.image_stage(
        out["planes"], out["committed_diff"], out["committed_spec"], hist,
        width, height)
    at = lambda t: RF.take(t, pix)
    # (P,H,W,3) denoised planes as one row a pixel
    stack = lambda a: a.permute(1, 2, 0, 3).reshape(width * height, -1)
    plane_offs = _off_fields(at(out["planes"]), res.planes)
    offs = {q: _any(_off_fields(at(out[q]), getattr(res, q)).values())
            for q in ("di_initial", "di_feedback", "gi_initial",
                      "gi_feedback")}
    offs.update({
        "planes": _any(plane_offs.values()),
        "radiance": _off(out["committed_diff"][pix], res.committed_diff)
        | _off(out["committed_spec"][pix], res.committed_spec),
        "denoised": _off(stack(out["denoised_diff"]), stack(dstack))
        | _off(stack(out["denoised_spec"]), stack(sstack)),
        "image": _off(out["image"].reshape(width * height, 3),
                      color.reshape(width * height, 3))})
    fb_di, fb_gi = at(out["di_feedback"]), at(out["gi_feedback"])
    di_flip = fb_di.light != res.di_feedback.light
    gi_flip = (fb_gi.valid != res.gi_feedback.valid) | ~torch.isclose(
        fb_gi.pos, res.gi_feedback.pos, rtol=1e-4, atol=1e-4).all(-1)
    numbers = {f"{q}_off_share": float(offs[q].to(torch.float64).mean())
               for q in QUANTITIES}
    # for the record: which fields of the planes are off, and how far the
    # fields with tolerances of their own part where the integer fields
    # agree
    numbers["planes_fields_off"] = {
        f: float(m.to(torch.float64).mean()) for f, m in plane_offs.items()}
    same = ~_any(plane_offs[f] for f in res.planes._fields if f in _INTS)
    prog_planes = at(out["planes"])
    for f in _ATOLS:
        d = (getattr(prog_planes, f) - getattr(res.planes, f)).abs()[same]
        numbers[f"planes_{f}_max_abs_diff"] = float(d.max()) if d.numel() \
            else 0.0
    numbers.update(
        di_flip_share=float(di_flip.to(torch.float64).mean()),
        gi_flip_share=float(gi_flip.to(torch.float64).mean()),
        frame_index_off=abs(out["frame_index"] - out["frames_rendered"])
        + abs(snap["frame_index"] - fi),
        pixels=int(pix.numel()),
        image_max_rel_diff=float(((out["image"] - color).abs()
                                  / (color.abs() + ATOL)).max()))
    return numbers


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
