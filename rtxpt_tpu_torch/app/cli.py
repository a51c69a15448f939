"""Headless render CLI (counterpart of rtxpt_tpu/app/cli.py; the
reference's --noWindow --screenshotFrameIndex golden-image contract,
RTXPT/CommandLine.h:16-34). Reference mode only.

    python -m rtxpt_tpu_torch.app.cli --mode reference \\
        --scene programmer-art --width 800 --height 600 --spp 8 \\
        --output out.png --dump-npy out.npy --device cuda
"""
from __future__ import annotations

import argparse
import sys
import time


def build_arg_parser():
    p = argparse.ArgumentParser("rtxpt_tpu_torch headless renderer")
    p.add_argument("--scene", default="programmer-art",
                   choices=["programmer-art"])
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=16,
                   help="samples per pixel (reference accumulation target)")
    p.add_argument("--mode", choices=["reference"], default="reference")
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
    p.add_argument("--no-jitter", action="store_true")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--no-auto-expose", action="store_true")
    p.add_argument("--sky-scale", type=float, default=1.0)
    p.add_argument("--checkpoint", default=None,
                   help="accumulation checkpoint file (.npz): resumes if "
                   "it exists, saves on exit")
    p.add_argument("--quiet", action="store_true")
    return p


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    import dataclasses

    from ..models.renderer import Renderer, reference_config
    from ..scene import envmap as EM
    from ..scene import procedural
    from ..utils import image as IM

    host = procedural.build_programmer_art(
        diffuse_only=args.diffuse_only).finish()
    cam = procedural.default_camera(args.width, args.height)
    cfg = reference_config(max_bounces=args.max_bounces,
                           nee_distant_samples=args.nee_distant_samples,
                           nee_local_samples=args.nee_local_samples)
    if args.max_diffuse_bounces is not None:
        cfg = dataclasses.replace(
            cfg, max_diffuse_bounces=args.max_diffuse_bounces)
    env = EM.bake_procedural_sky(sky_scale=args.sky_scale)
    spp = args.spp if args.screenshot_frame_index is None \
        else args.screenshot_frame_index

    r = Renderer(host, cam, cfg, env_radiance=env, device=args.device)
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
    srgb = r.tonemapped(hdr, exposure=args.exposure,
                        auto_expose=not args.no_auto_expose)
    _sync(args.device)
    total = time.time() - t0
    if not args.quiet:
        paths = args.width * args.height * spp
        print(f"rendered {args.width}x{args.height} @ {spp}spp on "
              f"{args.device} in {total:.2f}s "
              f"({paths / max(total, 1e-9) / 1e6:.2f} Mpaths/s)")
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
