"""Reference mode: back-to-back `Renderer.render(width, height, spp)`
calls of the port into one accumulation, a closed loop with a fixed
camera, each call ended by a device synchronize.

Set-up builds the scene from code, constructs the port's Renderer and
renders one warm-up call at the cell's size, whose samples are dropped
(`reset_accumulation`), so that the window's calls start from sample
index 0: every seed does the same work, and the seed draws only the
pixels that the check compares. The window runs calls until `seconds`
have passed since its start; the last call ends it. With `trace`, the
window's second call runs under `torch.profiler`, with the port's trace
calls wrapped in ranges of the same names, and is reduced to a Stretch
for the per-layer readers; `call_s`, the mean wall of the window's other
calls, is the length of a call that the profiler does not stretch. After
the window the drawn pixels of the accumulated image are read, the port's
renderer is freed, and the reference replays those pixels
(benchlib/check.py).
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from benchlib import check, profile, scenes


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TraceRanges:
    """Wraps the port's trace_closest / trace_anyhit in profiler ranges of
    the same names while active, keeping each call's `active` mask to
    count its rays after the stretch (no sync inside the stretch)."""

    def __init__(self, traverse_module):
        self.mod = traverse_module
        self.calls = []
        self.saved = {}

    def __enter__(self):
        for name in profile.TRACE_RANGES:
            fn = getattr(self.mod, name)
            self.saved[name] = fn

            def ranged(accel, origins, dirs, *a, _fn=fn, _name=name, **kw):
                active = kw.get("active", a[1] if len(a) > 1 else None)
                self.calls.append((_name, origins.shape[0], active))
                with torch.profiler.record_function(_name):
                    return _fn(accel, origins, dirs, *a, **kw)
            setattr(self.mod, name, ranged)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)

    def work(self):
        """(range name, active rays) of each call."""
        return [(name, n if act is None else int(act.sum()))
                for name, n, act in self.calls]


def run(ctx) -> dict:
    wl, cfg_file = ctx.workload, ctx.config
    device = torch.device(ctx.device)
    w, h, spp = int(wl["width"]), int(wl["height"]), int(wl["spp_per_call"])
    settings = cfg_file["settings"]
    rng = scenes.seed_rng(ctx.seed)
    camera = scenes.camera(cfg_file)
    pixels = check.draw_pixels(rng, w, h, int(wl["check"]["pixels"]))

    from rtxpt_tpu_torch.models import renderer as R
    from rtxpt_tpu_torch.ops import cuda_lib, traverse
    from rtxpt_tpu_torch.scene.camera import look_at

    t_build = time.perf_counter()
    host = scenes.host_scene(cfg_file)
    env = scenes.env_radiance(cfg_file)
    eye, target, fov_y = camera
    r = R.Renderer(host, look_at(w, h, eye, target, fov_y=fov_y),
                   R.reference_config(**settings), env_radiance=env,
                   device=device)
    _sync(device)
    host_build_s = time.perf_counter() - t_build
    r.render(w, h, spp)
    _sync(device)
    r.reset_accumulation()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = cuda_lib.launch_counts()

    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    calls, stretch, ranges, walls = 0, None, None, []
    t_end = t0
    while True:
        traced = ctx.trace and calls == 1
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with TraceRanges(traverse) as ranges, \
                    torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(profile.CALL_RANGE):
                    r.render(w, h, spp)
                    _sync(device)
        else:
            r.render(w, h, spp)
            _sync(device)
        calls += 1
        t_call, t_end = t_end, time.perf_counter()
        walls.append((t_end - t_call, traced))
        if t_end - t0 >= ctx.seconds:
            break
    window_s = t_end - t0
    plain = sorted(w for w, traced in walls if not traced)
    call_s = sum(plain) / len(plain)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    launches = {k: v - launches0.get(k, 0)
                for k, v in cuda_lib.launch_counts().items()
                if v - launches0.get(k, 0)}
    print(f"window: {calls} calls of {w}x{h}x{spp} in {window_s:.6f} s; "
          f"the port's kernel launches per call: "
          f"{ {k: v / calls for k, v in sorted(launches.items())} }",
          file=sys.stderr)
    print(f"calls: {len(plain)} untraced, wall s min {plain[0]:.6f} "
          f"median {plain[len(plain) // 2]:.6f} max {plain[-1]:.6f} mean "
          f"{call_s:.6f}; in order {[round(w, 4) for w, _ in walls]}",
          file=sys.stderr)

    program = r.accum.reshape(-1, 3)[torch.as_tensor(
        pixels, device=r.accum.device)].cpu()
    del r
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if ranges is not None:
        t_red = time.perf_counter()
        stretch = profile.from_profiler(prof)
        stretch.trace_work = ranges.work()
        del prof, ranges
        gc.collect()
        print(f"trace: {len(stretch.ops)} device events reduced in "
              f"{time.perf_counter() - t_red:.3f} s", file=sys.stderr)

    replay = dict(host=host, env_radiance=env, camera=camera,
                  settings=settings, width=w, height=h, spp=spp, calls=calls,
                  pixels=pixels, device=device)
    t_ref = time.perf_counter()
    reference = check.reference_pixels(**replay)
    print(f"check: the reference replayed {len(pixels)} pixels x {calls} "
          f"calls in {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    numbers = check.compare(program, reference)
    return {
        "end_to_end": {"paths_per_s": calls * w * h * spp / window_s / 1e6,
                       "setup_s": setup_s},
        "attempted": calls, "failed": 0,
        "numbers": numbers, "correct": check.verdict(numbers),
        "limits": dict(check.LIMITS),
        "memory_peak_bytes": int(memory_peak),
        "stretch": stretch, "host_build_s": host_build_s, "call_s": call_s,
        "triangles": int(host["indices"].shape[0]),
        "program": program, "reference": reference, "replay": replay,
    }
