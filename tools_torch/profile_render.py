"""Device-time breakdown of reference-mode renders or realtime frames of
the PyTorch port (rtxpt_tpu_torch) on a CUDA GPU, by kernel and by the
program's own spans (`rtxpt:` ranges, rtxpt_tpu_torch/utils/profiling.py).
A development tool, outside the package; from the repo root:

    python -m tools_torch.profile_render --scene city --width 1920 \\
        --height 1080 --spp 2

Builds the renderer with recording on (the build spans), renders once to
warm up, then `--calls` times each with recording off and on, in the
order off, on, on, off, ... (host clock, each ending in a device
synchronize; the first off and on images compared bit for bit), once each
under `torch.cuda.set_sync_debug_mode("warn")` with recording off and on
(the synchronizing calls counted by source line, and whether each lies
inside a `sync` span), and once each under torch.profiler without and
with recording (the profiler's stretch with and without the program's
ranges). Prints the card; the walls; the device time and launches of the
recorded profiled render grouped by kernel: the two-level trace, K6, K5,
the fused dense trace, K1, K7, K4, K2/K3, the sample generator, ReLAX's
and TAA's kernels and the PyTorch kernels of the tensor code, with the
device's busy share; the span table: a row per span name with its calls
per render call, host self ms per untraced recorded call, and the device
ms and kernels of the profiled render that start inside its device span
(the innermost); the bounce loop's lane
occupancy (sum of `bounce.live` over `bounce.width`), the host share
inside `sync` spans, `build/accel` seconds and the device ms of the
surface fetch and shade step (kernels starting inside `surface` and
`shade`, less those inside the traces); the longest idle gaps of the
profiled render, named by the innermost program span and the longest
host op at their start; and the PyTorch kernels that take the most device
time.

Reference mode: bench config, 6 bounces, 4 diffuse, NEE 1+1; `--set
key=value` (repeatable) overrides one of its PTConfig fields, e.g. `--set
shade_megakernel=False`, or `--set max_bounces=30 --set
max_diffuse_bounces=6 --set nee_distant_samples=2 --set
nee_local_samples=2` for the published reference configuration.
`--mode realtime` profiles frames of the default realtime pipeline (3
stable planes, ReSTIR DI + GI, ReLAX, TAA; 30 bounces / 3 diffuse, NEE
2+2), each after the last (the warm-up renders two: no history, then
history); its stages are the spans `realtime/<stage>`. There `--set`
overrides a field of that pipeline's PTConfig (e.g. `--set
use_stable_planes=False` for PSR-lite, `--set denoiser_method='reblur'`),
and `--display WxH` upscales each frame with TAAU to that display size.
"""
from __future__ import annotations

import argparse
import ast
import bisect
import collections
import contextlib
import heapq
import os
import subprocess
import sys
import time
import warnings

import torch

GROUPS = (("two-level trace (bvh8_trace_2l)", ("bvh8_2l_kernel",)),
          ("K6 probe (bvh8_trace_sub)", ("bvh8_kernel<false, true>",
                                         "bvh8_kernel<true, true>")),
          ("K5 one table (bvh8_trace)", ("bvh8_kernel<false, false>",
                                     "bvh8_kernel<true, false>")),
          ("dense trace, fused (mt_dense_fused)", ("mt_dense_fused_kernel",)),
          ("K1 dense trace", ("mt_dense_kernel",)),
          ("K7 worklists (tile_keys)", ("tile_keys_kernel",)),
          ("K4 shade", ("shade_nee_kernel",)),
          ("K2/K3 gathers", ("gather_rows_kernel", "gather_interp_kernel",
                             "gather_surface_kernel")),
          ("sample generator (rng_make, rng_start_effect, rng_next)",
           ("rng_make_kernel", "rng_start_effect_kernel", "rng_next_kernel")),
          ("ReLAX and TAA (relax_temporal, relax_variance, relax_atrous, "
           "taa_resolve)", ("relax_temporal_kernel", "relax_variance_kernel",
                            "relax_atrous_kernel", "taa_resolve_kernel")))
HOST_MIN_NS = 20_000     # shorter host ops cannot name an idle gap


def _group(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "PyTorch tensor code"


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _innermost(ops, spans):
    """For each (start, end, name) of `ops`, sorted by start, the name of
    the latest-starting span of `spans` (start, end, name) that holds its
    start, or None."""
    spans = sorted(spans)
    heap, out, j = [], [], 0
    for s, _, _ in ops:
        while j < len(spans) and spans[j][0] <= s:
            heapq.heappush(heap, (-spans[j][0], spans[j][1], spans[j][2]))
            j += 1
        while heap and heap[0][1] <= s:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def _inside(t, merged, starts) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < merged[i][1]


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out, [s for s, _ in out]


def _reduce(prof, prefix: str):
    """(device ops, device spans, host ranges, host ops) of a finished
    torch.profiler run from its raw events, in ns: each a list of (start,
    end, name); the spans and ranges are the program's (`prefix`)."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, spans, ranges, host = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name, iv = e.name(), (e.start_ns(), e.end_ns())
        if e.device_type() == cuda:
            (spans if name.startswith(prefix) else ops).append(
                iv + (name,))
        elif name.startswith(prefix):
            ranges.append(iv + (name[len(prefix):],))
        elif iv[1] - iv[0] >= HOST_MIN_NS:
            host.append(iv + (name,))
    for v in (ops, spans, ranges, host):
        v.sort()
    return ops, spans, ranges, host


def _recording(profiling, rec):
    """Recording into `rec` for the block, or nothing where it is None."""
    return contextlib.nullcontext() if rec is None else profiling.record(rec)


def _sync_sites(render, profiling, recording: bool):
    """One render under set_sync_debug_mode("warn"): (Counter of the
    synchronizing calls by source line, how many lay outside a `sync`
    span, the `sync` spans recorded)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sites, outside = collections.Counter(), [0]
    rec = profiling.FrameProfiler() if recording else None

    def show(message, category, filename, lineno, file=None, line=None):
        sites[f"{os.path.relpath(filename, root)}:{lineno}"] += 1
        if rec is not None and not (rec.stack
                                    and rec.stack[-1].name == "sync"):
            outside[0] += 1

    with warnings.catch_warnings(), _recording(profiling, rec):
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            render(sync=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites, outside[0], rec.counts.get("sync", 0) if rec else 0


def _span_cost(profiling, n: int = 200_000):
    """Host seconds of an empty loop iteration, and of one with an empty
    span and a counter in it, off and recording (no profiler active)."""
    def loop(body: bool):
        t0 = time.perf_counter()
        for _ in range(n):
            if body:
                with profiling.span("probe"):
                    profiling.count("probe", 1)
        return (time.perf_counter() - t0) / n

    bare, off = loop(False), loop(True)
    with profiling.record():
        on = loop(True)
    return bare, off, on


def main(argv=None) -> int:
    p = argparse.ArgumentParser("rtxpt_tpu_torch render profile")
    p.add_argument("--scene", default="city",
                   help="'programmer-art' | 'city' | a .gltf/.glb/"
                   ".scene.json path, as the CLI's --scene")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--mode", default="reference",
                   choices=["reference", "realtime"])
    p.add_argument("--calls", type=int, default=3,
                   help="timed renders with recording off, and as many on")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override a PTConfig field of the bench config "
                   "(reference mode) or of the default realtime pipeline "
                   "(a Python literal value)")
    p.add_argument("--display", default=None, metavar="WxH",
                   help="realtime mode: upscale each frame with TAAU to "
                   "this display size")
    args = p.parse_args(argv)
    overrides = {}
    for item in args.set:
        key, _, value = item.partition("=")
        overrides[key] = ast.literal_eval(value)
    if not torch.cuda.is_available():
        print("profile: needs a CUDA GPU", file=sys.stderr)
        return 1
    from rtxpt_tpu_torch.app.cli import load_scene
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM
    from rtxpt_tpu_torch.utils import profiling
    args.diffuse_only = False
    host, cam, extra = load_scene(args)
    env = extra.get("env_radiance")
    if env is None:
        env = EM.bake_procedural_sky(height=64)
    scene_kw = dict(analytic_lights=extra.get("analytic_lights"),
                    env_intensity=extra.get("env_intensity", 1.0))
    w, h, spp = args.width, args.height, args.spp
    with profiling.record() as build:
        if args.mode == "realtime":
            from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
            from rtxpt_tpu_torch.models.renderer import realtime_config
            cfg = realtime_config(**{**dict(
                use_restir_di=True, use_restir_gi=True,
                denoiser_enabled=True, use_stable_planes=True),
                **overrides})
            r = RealtimeRenderer(host, cam, cfg, env_radiance=env,
                                 device="cuda", **scene_kw)
        else:
            cfg = reference_config(**{**dict(
                max_bounces=6, max_diffuse_bounces=4, nee_distant_samples=1,
                nee_local_samples=1), **overrides})
            r = Renderer(host, cam, cfg, env_radiance=env, device="cuda",
                         **scene_kw)
    if args.mode == "realtime":
        spp = 1
        frame_kw = {}
        if args.display:
            frame_kw["display_size"] = tuple(
                int(v) for v in args.display.split("x"))

        def render(sync=True):
            out = r.render_frame(w, h, **frame_kw)
            if sync:
                torch.cuda.synchronize()
            return out

        render()                             # the no-history variant
    else:
        def render(sync=True):
            r.reset_accumulation()
            out = r.render(w, h, spp)
            if sync:
                torch.cuda.synchronize()
            return out

    render()                                         # warm-up
    walls = {False: [], True: []}
    images = {}
    rec = profiling.FrameProfiler()
    for i in range(2 * args.calls):
        on = i % 4 in (1, 2)
        with _recording(profiling, rec if on else None):
            t0 = time.perf_counter()
            img = render()
            walls[on].append(time.perf_counter() - t0)
        if on not in images:
            images[on] = img.clone()
    # a realtime frame follows the last one: only renders compare
    same = (torch.equal(images[False], images[True])
            if args.mode == "reference" else "n/a")
    sites_off, _, _ = _sync_sites(render, profiling, False)
    sites_on, outside, sync_spans = _sync_sites(render, profiling, True)
    sites_off2, _, _ = _sync_sites(render, profiling, False)
    bare, off_s, on_s = _span_cost(profiling)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof_walls = {}
    for on in (False, True):
        with torch.profiler.profile(activities=acts) as prof, \
                _recording(profiling, rec if on else None):
            t0 = time.perf_counter()
            render()
            prof_walls[on] = time.perf_counter() - t0
    ops, spans, ranges, host_ops = _reduce(prof, profiling.PREFIX)
    del prof
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    mean = lambda v: sum(v) / max(len(v), 1)
    what = "realtime frame" if args.mode == "realtime" else f"{spp}spp"
    if overrides:
        what += f" {overrides}"
    if args.display:
        what += f" -> TAAU {args.display}"
    wall = mean(walls[False])
    print(f"{card}; {args.scene} {w}x{h} {what}: untraced wall recording "
          f"off {[round(v, 4) for v in walls[False]]} s (mean "
          f"{wall * 1e3:.1f} ms, {w * h * spp / wall / 1e6:.3f} Mpaths/s), "
          f"recording on {[round(v, 4) for v in walls[True]]} s (mean "
          f"{mean(walls[True]) * 1e3:.1f} ms, "
          f"{mean(walls[True]) / wall - 1:+.2%}); images bit-identical: "
          f"{same}")
    print(f"  profiled render: {prof_walls[False] * 1e3:.1f} ms without the "
          f"program's ranges ({prof_walls[False] / wall:.2f}x), "
          f"{prof_walls[True] * 1e3:.1f} ms with them "
          f"({prof_walls[True] / wall:.2f}x)")
    print(f"  synchronizing calls a render: {sum(sites_off.values())} "
          f"recording off, {sum(sites_on.values())} on, "
          f"{sum(sites_off2.values())} off again; {sync_spans} `sync` "
          f"spans, {outside} calls outside one; by line: "
          f"{dict(sites_off.most_common())}; off minus on "
          f"{dict(sites_off - sites_on)}, on minus off "
          f"{dict(sites_on - sites_off)}")

    kernels = [o for o in ops if not _is_copy(o[2])]
    dev_us, count, by_name = {}, {}, {}
    for s, e, name in kernels:
        g = _group(name)
        dev_us[g] = dev_us.get(g, 0.0) + (e - s) / 1e3
        count[g] = count.get(g, 0) + 1
        if g == "PyTorch tensor code":
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    busy, _ = _merged((s, e) for s, e, _ in ops)
    busy_ms = sum(e - s for s, e in busy) / 1e6
    total = sum(dev_us.values())
    print(f"  device busy {busy_ms:.1f} ms: {busy_ms / (wall * 1e3):.1%} of "
          f"an untraced render, {busy_ms / (prof_walls[True] * 1e3):.1%} of "
          f"the profiled one; kernels {total / 1e3:.1f} ms, "
          f"{len(kernels)} launches, {len(ops) - len(kernels)} copies and "
          f"sets")
    for g in sorted(dev_us, key=dev_us.get, reverse=True):
        print(f"    {g}: {dev_us[g] / 1e3:.1f} ms device "
              f"({dev_us[g] / max(total, 1e-9):.1%}), {count[g]} launches")

    plain = [c for c in rec.calls if not c.profiled]
    owner = _innermost(ops, spans)
    span_ms = collections.defaultdict(float)
    span_kernels = collections.Counter()
    for (s, e, name), o in zip(ops, owner):
        key = o[len(profiling.PREFIX):] if o else "(none)"
        span_ms[key] += (e - s) / 1e6
        span_kernels[key] += not _is_copy(name)
    names = sorted({n for c in plain for n in c.spans} | set(span_ms),
                   key=lambda n: -span_ms.get(n, 0.0))
    print(f"  by span ({len(plain)} untraced recorded calls, mean wall "
          f"{mean([c.wall for c in plain]) * 1e3:.1f} ms; device: the "
          f"profiled render, each kernel in its innermost span):")
    print("    span              per call  host self ms   device ms  kernels")
    for n in names:
        cnt = mean([c.spans.get(n, (0, 0, 0))[0] for c in plain])
        slf = mean([c.spans.get(n, (0, 0, 0))[2] for c in plain])
        print(f"    {n:<18}{cnt:9.1f}{slf * 1e3:14.2f}"
              f"{span_ms.get(n, 0.0):12.2f}{span_kernels.get(n, 0):9d}")
    per_call = mean([sum(v[0] for v in c.spans.values()) for c in plain])
    counts = mean([c.spans.get("bounce", (0,))[0] * 2 for c in plain])
    print(f"  a span and a counter cost {(off_s - bare) * 1e6:.3f} us off, "
          f"{(on_s - bare) * 1e6:.3f} us recording (loop of 200,000); "
          f"{per_call:.0f} spans and {counts:.0f} counters a call, at "
          f"most: off {(off_s - bare) * per_call * 1e3:.3f} ms "
          f"({(off_s - bare) * per_call / wall:.4%} of an untraced call), "
          f"on {(on_s - bare) * per_call * 1e3:.3f} ms "
          f"({(on_s - bare) * per_call / wall:.4%})")
    live = sum(c.counters.get("bounce.live", 0) for c in plain)
    width = sum(c.counters.get("bounce.width", 0) for c in plain)
    sync_s = sum(c.spans.get("sync", (0, 0, 0))[1] for c in plain)
    by = lambda *ns: [(s, e) for s, e, n in spans
                      if n[len(profiling.PREFIX):] in ns]
    shade_iv, shade_st = _merged(by("surface", "shade"))
    trace_iv, trace_st = _merged(by("trace_closest", "trace_anyhit"))
    shade_ms = sum(e - s for s, e, _ in ops
                   if _inside(s, shade_iv, shade_st)
                   and not _inside(s, trace_iv, trace_st)) / 1e6
    walls_s = max(sum(c.wall for c in plain), 1e-9)
    print(f"  lane occupancy {live / max(width, 1):.4%} ({live} of {width} "
          f"lanes over the calls); sync share {sync_s / walls_s:.4%} of "
          f"the untraced calls' wall; build/accel "
          f"{build.totals.get('build/accel', 0.0):.4f} s (build spans "
          f"{ {k: round(v, 4) for k, v in build.totals.items()} }); "
          f"surface + shade device {shade_ms:.2f} ms")

    gaps = []
    for c0, c1 in ((s, e) for s, e, n in ranges if n == profiling.CALL):
        t = c0
        for s, e in busy:
            if e <= c0 or s >= c1:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < c1:
            gaps.append((t, c1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    print("  longest idle gaps of the profiled render (span/host op):")
    for g0, g1 in gaps:
        inner = _innermost([(g0, g0, None)], ranges)[0] or "-"
        op = max((iv for iv in host_ops if iv[0] <= g0 < iv[1]),
                 key=lambda iv: iv[1] - iv[0], default=(0, 0, "python"))[2]
        print(f"    {(g1 - g0) / 1e6:8.3f} ms  {profiling.PREFIX}{inner}/{op}")
    print("  largest PyTorch kernels:")
    for name in sorted(by_name, key=by_name.get, reverse=True)[:10]:
        print(f"    {by_name[name] / 1e3:.1f} ms  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
