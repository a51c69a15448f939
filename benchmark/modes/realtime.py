"""Realtime mode: a closed loop of `RealtimeRenderer.render_frame(width,
height, camera)` frames of the port, 1 spp each with the realtime
pipeline of the configuration, each frame ended by a device synchronize
(a presented frame).

The camera sweeps (benchlib/sweep.py): view `f` turns the configuration's
eye about the target's vertical axis, 0.25 degrees a frame, back and
forth over 60 frames, so the motion vectors, reprojection and history
rejection do real work, and view `f` depends on `f` alone. Set-up builds
the scene from code, constructs the renderer and renders the warm-up
frames on the path; the window continues the path. The seed draws only
the pixels that the check compares, so every seed does the same work.

With `trace`, the window's second frame runs under `torch.profiler` and
the port's `profiling.record()`, with the port's trace calls wrapped in
ranges (modes/reference.py `TraceRanges`); the reduced Stretch carries
the port's `rtxpt:` ranges as device spans and the frame's counters.
`call_s` is the mean wall of the window's other frames.

After the window the harness keeps the renderer's temporal state, renders
the check frame (the next view, same size), keeps what the port exposes
of it, frees the renderer, and replays the frame with the plain reference
(benchlib/check_rt.py).
"""
from __future__ import annotations

import gc
import importlib.util
import sys
import time
from pathlib import Path

import torch

from benchlib import check, check_rt, profile, scenes, sweep

PORT_PREFIX = "rtxpt:"


def _reference_mode():
    """modes/reference.py, for its TraceRanges."""
    path = Path(__file__).resolve().parent / "reference.py"
    spec = importlib.util.spec_from_file_location("bench_mode_reference",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_spans(st: profile.Stretch) -> profile.Stretch:
    """The device events of the port's `rtxpt:` ranges, which
    profile.from_profiler files among the operations, moved into the
    Stretch's spans."""
    ops = []
    for s, e, name in st.ops:
        if name.startswith(PORT_PREFIX):
            st.spans.setdefault(name, []).append((s, e))
        else:
            ops.append((s, e, name))
    st.ops = ops
    for v in st.spans.values():
        v.sort()
    return st


def run(ctx) -> dict:
    wl, cfg_file = ctx.workload, ctx.config
    device = torch.device(ctx.device)
    w, h = int(wl["width"]), int(wl["height"])
    settings = cfg_file["settings"]
    cam_cfg = wl["camera"]
    rng = scenes.seed_rng(ctx.seed)
    eye0, target, fov_y = scenes.camera(cfg_file)
    pixels = check.draw_pixels(rng, w, h, int(wl["check"]["pixels"]))
    view = lambda f: sweep.eye(eye0, target, f, float(cam_cfg["step_deg"]),
                               int(cam_cfg["period"]))
    TraceRanges = _reference_mode().TraceRanges

    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import realtime_config
    from rtxpt_tpu_torch.ops import cuda_lib, traverse
    from rtxpt_tpu_torch.scene.camera import look_at
    from rtxpt_tpu_torch.utils import profiling

    # what the check and the readers need of the program; a program
    # without it cannot run the cell, and stops before the scene's build
    missing = [n for n, ok in (
        ("RealtimeRenderer.last_restir_initial", "last_restir_initial"
         in RealtimeRenderer.__init__.__code__.co_names),
        ("profiling.count_device", hasattr(profiling, "count_device")))
        if not ok]
    if missing:
        raise SystemExit(f"benchmark: the program lacks {missing}, which "
                         "the realtime check reads")

    t_build = time.perf_counter()
    host = scenes.host_scene(cfg_file)
    env = scenes.env_radiance(cfg_file)
    r = RealtimeRenderer(host, look_at(w, h, eye0, target, fov_y=fov_y),
                         realtime_config(**settings), env_radiance=env,
                         device=device)
    _sync(device)
    host_build_s = time.perf_counter() - t_build
    rendered = 0

    def frame():
        nonlocal rendered
        img = r.render_frame(w, h, camera=look_at(w, h, view(rendered),
                                                  target, fov_y=fov_y))
        rendered += 1
        return img

    for _ in range(int(wl["warmup_frames"])):
        frame()
        _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = cuda_lib.launch_counts()

    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    frames, prof, ranges, rec, walls = 0, None, None, None, []
    t_end = t0
    while True:
        traced = ctx.trace and frames == 1
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with TraceRanges(traverse) as ranges, \
                    torch.profiler.profile(activities=acts) as prof, \
                    profiling.record() as rec:
                with torch.profiler.record_function(profile.CALL_RANGE):
                    frame()
                    _sync(device)
        else:
            frame()
            _sync(device)
        frames += 1
        t_call, t_end = t_end, time.perf_counter()
        walls.append((t_end - t_call, traced))
        if t_end - t0 >= ctx.seconds:
            break
    window_s = t_end - t0
    plain = sorted(x for x, traced in walls if not traced)
    call_s = sum(plain) / len(plain)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    launches = {k: v - launches0.get(k, 0)
                for k, v in cuda_lib.launch_counts().items()
                if v - launches0.get(k, 0)}
    print(f"window: {frames} frames of {w}x{h} in {window_s:.6f} s; the "
          f"port's kernel launches per frame: "
          f"{ {k: v / frames for k, v in sorted(launches.items())} }",
          file=sys.stderr)
    print(f"frames: {len(plain)} untraced, wall s min {plain[0]:.6f} "
          f"median {plain[len(plain) // 2]:.6f} max {plain[-1]:.6f} mean "
          f"{call_s:.6f}; in order {[round(x, 4) for x, _ in walls]}; "
          f"memory peak {memory_peak} bytes", file=sys.stderr)

    # the check frame: the next view, on the state the window left
    snap = check_rt.snapshot(r)
    cam_args = (view(rendered), view(rendered - 1), target, fov_y)
    image = frame()
    _sync(device)
    out = check_rt.outputs(r, image, rendered)
    del r
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stretch = None
    if prof is not None:
        t_red = time.perf_counter()
        stretch = port_spans(profile.from_profiler(prof))
        stretch.trace_work = ranges.work()
        stretch.counters = dict(rec.calls[-1].counters) if rec.calls else {}
        del prof, ranges
        gc.collect()
        print(f"trace: {len(stretch.ops)} device events reduced in "
              f"{time.perf_counter() - t_red:.3f} s; counters "
              f"{stretch.counters}", file=sys.stderr)

    replay = dict(host=host, env_radiance=env, settings=settings, width=w,
                  height=h, cam_args=cam_args, snap=snap, out=out,
                  pixels=pixels, device=device)
    t_ref = time.perf_counter()
    numbers = check_rt.replay(**replay)
    print(f"check: the reference replayed frame {rendered - 1} at "
          f"{len(pixels)} pixels and its image stages in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    return {
        "end_to_end": {"paths_per_s": frames * w * h / window_s / 1e6,
                       "setup_s": setup_s},
        "attempted": frames, "failed": 0,
        "numbers": numbers, "correct": check_rt.verdict(numbers),
        "limits": dict(check_rt.LIMITS),
        "memory_peak_bytes": int(memory_peak),
        "stretch": stretch, "host_build_s": host_build_s, "call_s": call_s,
        "triangles": int(host["indices"].shape[0]), "replay": replay,
    }
