"""Headless render CLI (counterpart of rtxpt_tpu/app/cli.py; the
reference's --noWindow --screenshotFrameIndex golden-image contract,
RTXPT/CommandLine.h:16-34).

    python -m rtxpt_tpu_torch.app.cli --mode reference \\
        --scene programmer-art --width 800 --height 600 --spp 8 \\
        --output out.png --dump-npy out.npy --device cuda

`--scene city` renders the Bistro-class procedural city (404,186
triangles, two-level BVH8); `--scene PATH` a .gltf / .glb file or a
.scene.json (its models, environment, camera, lights and settings), with
their PNG and DDS textures and alpha-MASK materials. `--mode realtime`
renders `--spp` frames of the realtime pipeline (3 stable planes, ReSTIR
DI + GI, ReLAX, TAA; NEE 1+1) and saves the last; `--no-stable-planes`
renders the single-plane PSR-lite pipeline instead; `--preset
ref-vs-realtime` strips either to the reference mode's estimator (no
ReSTIR, denoiser or TAA). `--env sky.hdr` lights the scene with a
Radiance .hdr (or an LDR .png) in place of the procedural sky;
`--no-nee` turns next-event estimation off, in both modes (the
reference's realtime mode ignores it); `--photo-denoise` runs the
offline photo-mode denoiser on a reference-mode render. A glTF scene's
animations: `--animate-time T` poses its skins and animated nodes at T
seconds before a reference render; `--animate` (realtime) advances them
before each frame, frame i at i / `--animate-fps`; `--animation-index`
picks the file's animation. The debug tools (reference mode):
`--debug-view NAME` saves a debug channel (utils/debugviews.py VIEWS)
in place of the render; after the render, `--debug-print-pixel X,Y`
prints the pixel's DebugPrint slots, `--debug-delta-tree X,Y` its delta
tree, and `--debug-lines-pixel X,Y` draws its bounce chain over the
saved image.
"""
from __future__ import annotations

import argparse
import sys
import time


def build_arg_parser():
    p = argparse.ArgumentParser("rtxpt_tpu_torch headless renderer")
    p.add_argument("--scene", default="programmer-art",
                   help="'programmer-art' | 'city' (Bistro-class, 404,186 "
                   "triangles) | path to .gltf/.glb/.scene.json")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=16,
                   help="samples per pixel (reference accumulation target)")
    p.add_argument("--mode", choices=["reference", "realtime"],
                   default="reference")
    p.add_argument("--preset", choices=["ref-vs-realtime"], default=None,
                   help="realtime: the reference mode's estimator "
                   "(LocalConfig REF_VS_REALTIME)")
    p.add_argument("--stable-planes",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="realtime: the 3-plane stable-planes pipeline "
                   "(BUILD/FILL); --no-stable-planes renders PSR-lite")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernels, "
                   "'cpu' their plain PyTorch versions")
    p.add_argument("--output", default="out.png",
                   help="screenshot file name (PNG)")
    p.add_argument("--dump-npy", default=None,
                   help="also dump linear HDR as .npy")
    p.add_argument("--screenshot-frame-index", type=int, default=None,
                   help="render this many samples then save+exit "
                   "(overrides --spp)")
    p.add_argument("--diffuse-only", action="store_true",
                   help="all materials lambertian")
    p.add_argument("--max-bounces", type=int, default=30)
    p.add_argument("--max-diffuse-bounces", type=int, default=None)
    p.add_argument("--nee-distant-samples", type=int, default=2)
    p.add_argument("--nee-local-samples", type=int, default=2)
    p.add_argument("--no-nee", action="store_true",
                   help="no next-event estimation (emission and the sky "
                   "are found by scatter rays alone)")
    p.add_argument("--no-jitter", action="store_true")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--no-auto-expose", action="store_true")
    p.add_argument("--sky-scale", type=float, default=1.0)
    p.add_argument("--env", default=None,
                   help="equirect environment texture (Radiance .hdr or "
                   ".png) in place of the procedural sky")
    p.add_argument("--photo-denoise", action="store_true",
                   help="reference mode: run the offline photo-mode "
                   "denoiser on the result (the OptiX/OIDN slot)")
    p.add_argument("--checkpoint", default=None,
                   help="accumulation checkpoint file (.npz): resumes if "
                   "it exists, saves on exit")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--animate-time", type=float, default=None,
                   help="pose glTF animations at this time (seconds) "
                   "before rendering (reference mode; SampleUI's "
                   "animation scrubber)")
    p.add_argument("--animate", action="store_true",
                   help="realtime mode: advance glTF animations every "
                   "frame at --animate-fps")
    p.add_argument("--animate-fps", type=float, default=60.0)
    p.add_argument("--animation-index", type=int, default=0)
    p.add_argument("--debug-view", default=None,
                   help="reference mode: render a debug channel instead of "
                   "the beauty pass (ShaderDebug DebugViewType); see "
                   "rtxpt_tpu_torch.utils.debugviews.VIEWS")
    p.add_argument("--debug-print-pixel", default=None, metavar="X,Y",
                   help="print the DebugPrint slot table of pixel X,Y "
                   "after the render (ShaderDebug.hlsli Print + feedback "
                   "readback)")
    p.add_argument("--debug-delta-tree", default=None, metavar="X,Y",
                   help="explore pixel X,Y's delta tree after the render "
                   "and print the branch and plane report "
                   "(DeltaTreeVizExplorePixel, Sample.hlsl:332-357)")
    p.add_argument("--debug-lines-pixel", default=None, metavar="X,Y",
                   help="overlay the traced bounce chain of pixel X,Y as "
                   "debug lines on the output (the pick-pixel DebugLines "
                   "visualization)")
    return p


def load_scene(args):
    """(host scene dict, camera, extra) for --scene; extra: the scene
    file's env_radiance, env_intensity, analytic_lights and settings, and
    a glTF file's info as anim_info (what Renderer.animate poses)."""
    from ..scene import procedural
    if args.scene == "programmer-art":
        return (procedural.build_programmer_art(
            diffuse_only=args.diffuse_only).finish(),
            procedural.default_camera(args.width, args.height), {})
    if args.scene == "city":
        # Bistro-class stress scene (BASELINE config 5 fixture)
        return (procedural.build_city().finish(),
                procedural.city_camera(args.width, args.height), {})
    if args.scene.endswith((".gltf", ".glb")):
        from ..scene import gltf
        from ..scene.texcache import TextureCache
        host, info = gltf.load_gltf(args.scene, texture_cache=TextureCache())
        if info["textures"]:
            host["texture_images"] = info["textures"]
            host["texture_srgb"] = info["texture_srgb"]
        return (host, gltf.camera_from_info(info, args.width, args.height),
                dict(analytic_lights=gltf.analytic_lights_from_info(info),
                     anim_info=info))
    if args.scene.endswith(".json"):
        from ..scene import scene_json
        return scene_json.load_scene_json(args.scene, args.width,
                                          args.height)
    raise SystemExit(f"unknown scene: {args.scene}")


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _run_realtime(args, host, cam, env, frames: int, settings: dict,
                  anim_info=None, **scene_kw) -> int:
    """Realtime mode: `frames` frames, the last one saved (the reference's
    --screenshotFrameIndex contract, with denoiser warm-up)."""
    from ..config import apply_scene_settings
    from ..models.realtime import RealtimeRenderer
    from ..models.renderer import realtime_config
    from ..post.tonemap import tonemap
    from ..utils import image as IM

    restir = args.preset != "ref-vs-realtime"
    cfg = realtime_config(use_restir_di=restir, use_restir_gi=restir,
                          denoiser_enabled=restir,
                          use_stable_planes=args.stable_planes,
                          max_bounces=args.max_bounces,
                          max_diffuse_bounces=args.max_diffuse_bounces or 3,
                          nee_enabled=not args.no_nee,
                          nee_distant_samples=1, nee_local_samples=1)
    cfg = apply_scene_settings(cfg, settings)
    r = RealtimeRenderer(host, cam, cfg, env_radiance=env,
                         device=args.device, **scene_kw)
    times = [time.time()]
    img = None
    for i in range(max(frames, 1)):
        if args.animate and anim_info is not None:
            # per-frame animation tick (DeviceManager Animate + Render)
            r.animate(anim_info, i / args.animate_fps, args.animation_index)
        img = r.render_frame(args.width, args.height, taa=restir)
        _sync(args.device)
        times.append(time.time())
        if not args.quiet and (i % max(1, frames // 8) == 0
                               or i == frames - 1):
            print(f"  frame {i + 1}/{frames} "
                  f"({(times[-1] - times[-2]) * 1000:.0f} ms)", flush=True)
    steady = (times[-1] - times[1]) / max(len(times) - 2, 1) \
        if len(times) > 2 else times[-1] - times[0]
    if not args.quiet:
        print(f"realtime {args.width}x{args.height} on {args.device}: "
              f"steady {steady * 1000:.0f} ms/frame")
    srgb = tonemap(img, exposure=args.exposure,
                   auto_expose=not args.no_auto_expose)
    IM.save_png(args.output, srgb.cpu().numpy())
    if args.dump_npy:
        IM.save_npy(args.dump_npy, img.cpu().numpy())
    if not args.quiet:
        print(f"wrote {args.output}")
    return 0


def _pixel_arg(text: str):
    x, y = (int(v) for v in text.split(","))
    return x, y


def _debug_tools(args, r, cam, srgb):
    """The post-render debug flags on renderer `r` and camera `cam`: print
    the DebugPrint slots and the delta tree, and overlay the debug lines
    on the tonemapped image `srgb`, which is returned."""
    if args.debug_print_pixel:
        from ..utils import debugprint as DP
        print(DP.format_slots(DP.print_path(
            r.assets, cam, *_pixel_arg(args.debug_print_pixel))))
    if args.debug_delta_tree:
        from ..utils import deltatree as DT
        print(DT.format_tree(DT.explore_pixel(
            r.assets, cam, *_pixel_arg(args.debug_delta_tree))))
    if args.debug_lines_pixel:
        from ..utils import debuglines as DL
        dx, dy = _pixel_arg(args.debug_lines_pixel)
        srgb = DL.rasterize_overlay(
            srgb, DL.lines_for_path(r.assets, cam, dx, dy), cam)
        if not args.quiet:
            print(f"debug lines: pixel ({dx},{dy}) path overlay")
    return srgb


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    import dataclasses

    import torch

    from ..config import apply_scene_settings
    from ..models.renderer import Renderer, reference_config
    from ..scene import envmap as EM
    from ..utils import image as IM

    host, cam, extra = load_scene(args)
    cfg = reference_config(max_bounces=args.max_bounces,
                           nee_enabled=not args.no_nee,
                           nee_distant_samples=args.nee_distant_samples,
                           nee_local_samples=args.nee_local_samples)
    if args.max_diffuse_bounces is not None:
        cfg = dataclasses.replace(
            cfg, max_diffuse_bounces=args.max_diffuse_bounces)
    settings = extra.get("settings", {})
    cfg = apply_scene_settings(cfg, settings)
    env = extra.get("env_radiance")
    if args.env:
        env = EM.load_equirect(args.env)
    if env is None:
        env = EM.bake_procedural_sky(sky_scale=args.sky_scale)
    scene_kw = dict(analytic_lights=extra.get("analytic_lights"),
                    env_intensity=extra.get("env_intensity", 1.0))
    spp = args.spp if args.screenshot_frame_index is None \
        else args.screenshot_frame_index
    anim_info = extra.get("anim_info")
    if args.mode == "realtime":
        return _run_realtime(args, host, cam, env, spp, settings,
                             anim_info=anim_info, **scene_kw)

    r = Renderer(host, cam, cfg, env_radiance=env, device=args.device,
                 **scene_kw)
    if args.animate_time is not None and anim_info is not None:
        # pose skinned and rigid node animations (Scene::Refresh) at T
        r.animate(anim_info, args.animate_time, args.animation_index)
    # the debug tools see the output size as the camera's viewport
    cam_dbg = r.camera._replace(viewport=torch.tensor(
        [args.width, args.height], dtype=torch.float32, device=r.device))
    if args.debug_view:
        from ..utils import debugviews as DV
        img = DV.render_debug_view(args.debug_view, r.assets, cam_dbg,
                                   args.width, args.height)
        IM.save_png(args.output, img.cpu().numpy())
        if not args.quiet:
            print(f"wrote debug view {args.debug_view} -> {args.output}")
        return 0
    if args.checkpoint:
        r.load_checkpoint(args.checkpoint)

    t0 = time.time()
    times = []

    def progress(i):
        _sync(args.device)
        times.append(time.time())
        if not args.quiet:
            dt = times[-1] - (times[-2] if len(times) > 1 else t0)
            print(f"  sample {i}/{spp}  ({dt * 1000:.0f} ms since last "
                  "report)", flush=True)

    hdr = r.render(args.width, args.height, spp, not args.no_jitter,
                   progress)
    if args.photo_denoise:
        from ..denoise.offline import photo_denoise_auto
        hdr = photo_denoise_auto(r, hdr, args.width, args.height)
        if not args.quiet:
            print("photo-mode denoise applied (offline OIDN slot)")
    srgb = r.tonemapped(hdr, exposure=args.exposure,
                        auto_expose=not args.no_auto_expose)
    _sync(args.device)
    total = time.time() - t0
    if not args.quiet:
        paths = args.width * args.height * spp
        print(f"rendered {args.width}x{args.height} @ {spp}spp on "
              f"{args.device} in {total:.2f}s "
              f"({paths / max(total, 1e-9) / 1e6:.2f} Mpaths/s)")
    srgb = _debug_tools(args, r, cam_dbg, srgb)
    IM.save_png(args.output, srgb.cpu().numpy())
    if args.dump_npy:
        IM.save_npy(args.dump_npy, hdr.cpu().numpy())
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
    if not args.quiet:
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
