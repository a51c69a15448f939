"""Two-level trace lab: the modes of the fused two-level kernel
(``csrc/bvh8_trace.cu`` `rtxpt_bvh8_trace_2l_variant`) on the city's
captured first-bounce traces, and the flat-BVH8 question of ROADMAP §1
item 6. Modes (csrc/bvh8_trace.cu enum Mode):

    shared_persistent  the main path's: stack in shared memory,
                       persistent warps
    shared_flat        stack in shared memory, one thread per ray
    local_persistent   stack in local memory, persistent warps
    local_flat         stack in local memory, one thread per ray

Each mode's result must equal the main kernel's bit for bit; the times
say how much of the trace is its stack and how much its scheduling.

    python -m tools_torch.profile_bvh8

Renders the first bounce of a 1920x1080 1-spp city render (bench config)
to capture its two-level traces (camera, NEE any-hit, scattered), prints
each mode's time on each, then tries to collapse the whole city into one
BVH8 (the single-table tier) and times K5 on it against the two-level
launch on the same rays, or prints why the collapse is refused. Needs a
CUDA GPU.
"""
from __future__ import annotations

import subprocess
import time

import torch

from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.ops import traverse_bvh8 as T8
from tools_torch.kernel_lab import time_ms

MODES = ("shared_persistent", "shared_flat", "local_persistent",
         "local_flat")


@cuda_lib.counted("bvh8_trace_2l_variant")
def trace_2l_variant(tl, origins, dirs, t_max, active, *, any_hit: bool,
                     mode: str):
    """`traverse_bvh8.trace_bvh8_2l` in lab mode `mode` (CUDA only)."""
    if not cuda_lib.on_cuda(tl.sub_tables, origins, dirs, t_max, active):
        raise ValueError("the two-level lab runs on a CUDA device")
    return T8.launch_two_level("rtxpt_bvh8_trace_2l_variant",
                               "bvh8_trace_2l_variant", tl, origins, dirs,
                               t_max, active, any_hit, MODES.index(mode))


def _equal(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def run_modes(args, kw) -> dict:
    """Each mode on one captured trace (args, kw of trace_bvh8_2l),
    required to equal the main kernel's result -> {mode: ms}."""
    ref = T8.trace_bvh8_2l(*args, **kw)
    out = {}
    for mode in MODES:
        got = trace_2l_variant(*args, **kw, mode=mode)
        if not _equal(got, ref):
            raise RuntimeError(f"two-level mode {mode} differs from the "
                               "main kernel")
        out[mode] = time_ms(lambda: trace_2l_variant(*args, **kw,
                                                     mode=mode), 20)
    return out


def capture_traces(host, w: int = 1920, h: int = 1080) -> dict:
    """The (args, kw) of the first three two-level traces of one
    bench-config sample of the city: {"camera", "nee any-hit",
    "scattered"}."""
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                           nee_distant_samples=1, nee_local_samples=1)
    r = Renderer(host, procedural.city_camera(w, h), cfg,
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    calls, orig = [], T8.trace_bvh8_2l

    def capture(*args, **kw):
        if len(calls) < 3:
            calls.append(([a.clone() if torch.is_tensor(a) else a
                           for a in args], dict(kw)))
        return orig(*args, **kw)

    T8.trace_bvh8_2l = capture
    try:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    finally:
        T8.trace_bvh8_2l = orig
    return dict(zip(("camera", "nee any-hit", "scattered"), calls))


def flat_city(host, traces):
    """K5 on one BVH8 of the whole city against the two-level launch on
    the same rays, or the reason the collapse is refused."""
    from rtxpt_tpu_torch.ops import bvh
    pos, idx = host["positions"], host["indices"]
    t0 = time.perf_counter()
    try:
        flat = bvh.collapse_bvh8(bvh.build_bvh(pos, idx), pos, idx,
                                 device="cuda")
    except ValueError as e:
        print(f"flat BVH8 of the city ({idx.shape[0]} triangles): refused "
              f"by collapse_bvh8 ({e})", flush=True)
        return
    print(f"flat BVH8 of the city: {flat.num_rows} rows, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for what, (args, kw) in traces.items():
        _, o, d, tm, act = args
        f_args = (flat.table, flat.leaf_omm, o, d, tm, act)
        f_kw = dict(leaf_size=flat.leaf_size, any_hit=kw["any_hit"])
        t, slot, _ = T8.trace_bvh8(*f_args, **f_kw)
        ref = T8.trace_bvh8_2l(*args, **kw)
        if kw["any_hit"]:
            agree = ((slot >= 0) == ref)[act].float().mean()
        else:
            prim = torch.where(slot >= 0, flat.leaf_tris[slot.clamp(min=0)],
                               -1)
            agree = (prim == ref.prim)[act].float().mean()
        flat_ms = time_ms(lambda: T8.trace_bvh8(*f_args, **f_kw), 20)
        two_ms = time_ms(lambda: T8.trace_bvh8_2l(*args, **kw), 20)
        print(f"{what}: flat K5 {flat_ms:.4f} ms, two-level "
              f"{two_ms:.4f} ms, same result on {float(agree):.6%} of "
              f"active lanes", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_bvh8 needs a CUDA GPU")
    from rtxpt_tpu_torch.scene import procedural
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    host = procedural.build_city().finish()
    traces = capture_traces(host)
    print(f"{card}; city 1920x1080 first bounce, two-level traces")
    for what, (args, kw) in traces.items():
        ms = run_modes(args, kw)
        print(f"{what} ({args[1].shape[0]} lanes, {int(args[4].sum())} "
              "active): " + ", ".join(f"{m} {v:.4f} ms"
                                      for m, v in ms.items()), flush=True)
    flat_city(host, traces)


if __name__ == "__main__":
    main()
