"""Device-time breakdown of one render (reference mode) or one frame
(realtime mode) of the PyTorch port (rtxpt_tpu_torch) on a CUDA GPU. A
development tool, outside the package; from the repo root:

    python -m tools_torch.profile_render --scene city --width 1920 \\
        --height 1080 --spp 2

Renders once to warm up, once more timed (host clock, ending in a device
synchronize), then once under torch.profiler, and prints the card, the
timed wall, and the profiled render's device time and launches grouped by
kernel: K6 (BVH8 probe), K5 (BVH8 sweep), K1 (dense trace), K7 (its
worklists), K4 (shade),
K2/K3 (gathers) and the PyTorch kernels of the tensor code around them,
with the device's busy share of the profiled wall; then the device time
of the kernels that ran inside the closest-hit and any-hit trace calls
(K1/K5/K6 and the PyTorch code of the two-level probe and sweep) beside
the device span of those calls, and the PyTorch kernels that take the
most device time. Bench config: 6 bounces, 4 diffuse, NEE 1+1.

`--mode realtime` profiles one frame of the default realtime pipeline
(3 stable planes, ReSTIR DI + GI, ReLAX, TAA; 30 bounces / 3 diffuse,
NEE 2+2) after two warm-up frames (no history, then history), and adds a
split of that frame by stage (the "realtime:<stage>" profiler ranges of
`models/realtime.py`: build, restir_di, fill, restir_gi, relax, taa): each
stage's host wall and the device time of the kernels inside its span.

The trace calls are timed by wrapping the port's `ops.traverse` functions
in profiler ranges for the length of the run.
"""
from __future__ import annotations

import argparse
import bisect
import subprocess
import sys
import time

import torch

RANGES = ("trace_closest", "trace_anyhit")
STAGES = ("realtime:build", "realtime:restir_di", "realtime:fill",
          "realtime:restir_gi", "realtime:relax", "realtime:taa")
GROUPS = (("K6 probe (bvh8_trace_sub)", ("bvh8_kernel<false, true>",
                                         "bvh8_kernel<true, true>")),
          ("K5 sweep (bvh8_trace)", ("bvh8_kernel<false, false>",
                                     "bvh8_kernel<true, false>")),
          ("K1 dense trace", ("mt_dense_kernel",)),
          ("K7 worklists (tile_keys)", ("tile_keys_kernel",)),
          ("K4 shade", ("shade_nee_kernel",)),
          ("K2/K3 gathers", ("gather_rows_kernel", "gather_interp_kernel")))


def _group(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "PyTorch tensor code"


def main(argv=None) -> int:
    p = argparse.ArgumentParser("rtxpt_tpu_torch render profile")
    p.add_argument("--scene", default="city",
                   choices=["programmer-art", "city"])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--mode", default="reference",
                   choices=["reference", "realtime"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: needs a CUDA GPU", file=sys.stderr)
        return 1
    from rtxpt_tpu_torch.app.cli import load_scene
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM
    args.diffuse_only = False
    host, cam = load_scene(args)
    env = EM.bake_procedural_sky(height=64)
    w, h, spp = args.width, args.height, args.spp
    if args.mode == "realtime":
        from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
        r = RealtimeRenderer(host, cam, env_radiance=env, device="cuda")
        spp = 1

        def render():
            r.render_frame(w, h)
            torch.cuda.synchronize()

        render()                             # the no-history variant
    else:
        cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                               nee_distant_samples=1, nee_local_samples=1)
        r = Renderer(host, cam, cfg, env_radiance=env, device="cuda")

        def render():
            r.reset_accumulation()
            r.render(w, h, spp)
            torch.cuda.synchronize()

    from rtxpt_tpu_torch.ops import traverse
    for fname in RANGES:
        def ranged(*a, _fn=getattr(traverse, fname), _name=fname, **kw):
            with torch.profiler.record_function(_name):
                return _fn(*a, **kw)
        setattr(traverse, fname, ranged)

    render()                                         # warm-up
    t0 = time.perf_counter()
    render()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render()
        prof_wall = time.perf_counter() - t0
    kernels, spans, stage_dev, stage_host = [], [], [], {}
    for e in prof.events():
        tr = e.time_range
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name in STAGES:
                stage_host[e.name] = stage_host.get(e.name, 0.0) \
                    + tr.end - tr.start
            continue
        # the ranges appear on the device timeline as annotations
        if e.name in STAGES:
            stage_dev.append((tr.start, tr.end, e.name))
            continue
        (spans if e.name in RANGES else kernels).append(
            (tr.start, tr.end, e.name))
    spans.sort()
    starts = [sp[0] for sp in spans]
    dev_us, count, by_name = {}, {}, {}
    inside = {name: 0.0 for name in RANGES}
    span_us = {name: 0.0 for name in RANGES}
    for start, end, name in spans:
        span_us[name] += end - start
    for start, end, name in kernels:
        g = _group(name)
        dev_us[g] = dev_us.get(g, 0.0) + (end - start)
        count[g] = count.get(g, 0) + 1
        if g == "PyTorch tensor code":
            by_name[name] = by_name.get(name, 0.0) + (end - start)
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < spans[i][1]:
            inside[spans[i][2]] += end - start
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    total = sum(dev_us.values())
    what = "realtime frame" if args.mode == "realtime" else f"{spp}spp"
    print(f"{card}; {args.scene} {w}x{h} {what}: wall {wall * 1e3:.1f} ms "
          f"({w * h * spp / wall / 1e6:.3f} Mpaths/s); profiled wall "
          f"{prof_wall * 1e3:.1f} ms, device busy {total / 1e3:.1f} ms "
          f"({total / 1e3 / (prof_wall * 1e3):.1%})")
    for g in sorted(dev_us, key=dev_us.get, reverse=True):
        print(f"  {g}: {dev_us[g] / 1e3:.1f} ms device "
              f"({dev_us[g] / max(total, 1e-9):.1%}), {count[g]} launches")
    for name in RANGES:
        print(f"  kernels inside {name}: {inside[name] / 1e3:.1f} ms device "
              f"(device span of the calls {span_us[name] / 1e3:.1f} ms)")
    if args.mode == "realtime":
        print("  by stage (host wall of the range; device time of the "
              "kernels that start inside its device span):")
        for name in STAGES:
            dev = sum(end - start for start, end, _ in kernels
                      if any(s0 <= start < s1 for s0, s1, n in stage_dev
                             if n == name))
            print(f"    {name[9:]}: host {stage_host.get(name, 0.0) / 1e3:.1f}"
                  f" ms, device {dev / 1e3:.1f} ms")
    print("  largest PyTorch kernels:")
    for name in sorted(by_name, key=by_name.get, reverse=True)[:10]:
        print(f"    {by_name[name] / 1e3:.1f} ms  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
