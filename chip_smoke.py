#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rtxpt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line; each prints
its seconds):
  1. print the card (nvidia-smi name, power limit); build the CUDA kernels
     from csrc/ with nvcc for sm_90a, the renderer's library and the K8
     lab's (one nvcc per source, all started together);
  2. hold K1-K4 and K7 against their plain PyTorch versions on the card,
     on the inputs of the first bounces of an 800x600 programmer-art render
     (480,000 camera rays, then scattered and NEE rays), and time both
     (and K2 against torch.index_select); K7's worklist keys must be
     bit-equal on every captured K1 trace, and its visits per tile are
     printed;
  3. render 64x48 2spp and 160x120 8spp with reference_config() and hold
     them against the goldens in assets/ (PSNR > 40 dB, SMAPE < 0.02, the
     cross-platform gate); hold the 64x48 GPU render against the port's
     CPU render of the same frame (PSNR > 40 dB);
  4. render the bench workload (800x600, 6 bounces / 4 diffuse, NEE 1+1,
     8 spp as one regenerating wavefront) with every launch counter set to
     0 just before, and require K1-K4 and K7 to have launched; then render
     it once more unsorted and once with wavefront_sort="raystream", print
     both walls and visits per tile, require K1 and K7 to have launched in
     the sorted render and its image to equal the unsorted one (rtol 1e-5,
     atol 1e-6, tests/test_raystream_sort.py);
  5. the city: build the default procedural city (404,186 triangles,
     two-level BVH8); hold K6 (the probe), K5 (the sweep) and K2-K4 (the
     gathers from the city's tables, the shade pass) against their plain
     versions on the launches of the first bounce of a 1920x1080 1-spp
     render, and time both; render it at 1920x1080, bench config, 2 spp
     as one regenerating chunk, after a warm-up render, with the counters
     set to 0 just before, and require K2-K6 to have launched; hold a
     64x36 GPU render against the port's CPU render (PSNR > 40 dB);
  6. realtime: the default realtime pipeline (3 stable planes, ReSTIR DI
     + GI, ReLAX, TAA; 30 bounces / 3 diffuse, NEE 2+2). On the city at
     1920x1080 and on programmer-art at 640x360 (the bench's realtime
     case): capture the first launches of each kernel in one frame (the
     BUILD pass's camera trace, the first FILL bounce's gathers and K4
     FILL, the first FILL NEE trace that casts a ray, the fused ReSTIR
     final shade's visibility trace) and hold each kernel of the path
     against its plain version on them (city: K2, K3, K4 FILL, K5, K6;
     360p: K1, K2, K3, K4 FILL, K7); after the no-history and the history
     warm-up frames, time 3 frames with the
     counters set to 0 just before, and require the path's kernels to
     have launched and the frame to be finite and not black. Then the
     port on the card against the port on the CPU (programmer-art 64x48,
     3 frames, PSNR > 40 dB), and the estimator oracle of
     tests/test_ref_vs_realtime.py on the card: the mean of 32
     `ref-vs-realtime` frames at 48x32 against the port's 32-spp
     reference render (median block error < 0.25, means within 10%);
  7. the labs: every micro-kernel of the traversal-ingredient lab (K8,
     tools_torch/kernel_lab.py) against its plain version at 16
     iterations, and its microseconds per iteration at 2,000; each mode of
     the dense-trace lab (K9, tools_torch/profile_mt_kernel.py) on the
     bench camera rays, the "gate" mode's visit counts equal to its plain
     version and the others' winners against the plain K1;
  8. print a JSON line describing the kernels (each kernel's numbers on
     every path that checks it under `by_path`; at the top level, those
     of the first such path, named in `measured_on`), then the result line.

Each kernel's `bound_ms` is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its float operations over
67 TFLOP/s (H100 SXM, NVIDIA's data sheet), for the work of the launches
its `ms` sums.

Needs CUDA: exits non-zero without printing a result when
torch.cuda.is_available() is false.
"""
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    # name: (launch counter, source, TPU kernel it replaces)
    "mt_dense": ("mt_dense", "rtxpt_tpu_torch/csrc/mt_dense.cu",
                 "rtxpt_tpu/ops/mt_dense.py:947"),
    "gather_rows": ("gather_rows", "rtxpt_tpu_torch/csrc/gather.cu",
                    "rtxpt_tpu/ops/gather_pallas.py:128"),
    "gather_rows_interp": ("gather_rows_interp",
                           "rtxpt_tpu_torch/csrc/gather.cu",
                           "rtxpt_tpu/ops/gather_pallas.py:183"),
    "shade_nee": ("shade_nee", "rtxpt_tpu_torch/csrc/shade_kernel.cu",
                  "rtxpt_tpu/pt/shade_kernel.py:1049"),
    "shade_nee_fill": ("shade_nee_fill",
                       "rtxpt_tpu_torch/csrc/shade_kernel.cu",
                       "rtxpt_tpu/pt/shade_kernel.py:1049"),
    "bvh8_trace": ("bvh8_trace", "rtxpt_tpu_torch/csrc/bvh8_trace.cu",
                   "rtxpt_tpu/ops/traverse_pallas.py:279"),
    "bvh8_trace_sub": ("bvh8_trace_sub",
                       "rtxpt_tpu_torch/csrc/bvh8_trace.cu",
                       "rtxpt_tpu/ops/traverse_pallas.py:380"),
    "tile_keys": ("tile_keys", "rtxpt_tpu_torch/csrc/mt_dense.cu",
                  "rtxpt_tpu/ops/mt_dense.py:490"),
}
# the kernels each main path must launch
BENCH_PATH = ("mt_dense", "tile_keys", "gather_rows", "gather_rows_interp",
              "shade_nee")
CITY_PATH = ("bvh8_trace", "bvh8_trace_sub", "gather_rows",
             "gather_rows_interp", "shade_nee")
RT_CITY_PATH = ("bvh8_trace", "bvh8_trace_sub", "gather_rows",
                "gather_rows_interp", "shade_nee_fill")
RT_ART_PATH = ("mt_dense", "tile_keys", "gather_rows", "gather_rows_interp",
               "shade_nee_fill")
PATHS = {"bench": BENCH_PATH, "city": CITY_PATH,
         "realtime_city": RT_CITY_PATH, "realtime_360p": RT_ART_PATH}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM float32, outside the tensor cores
# float operations of one unit of work (counted from the kernels' source)
SLAB_OPS = 25                  # one ray-box slab test
NODE_ROW_OPS = 8 * SLAB_OPS + 19   # 8 child slabs + the sorting network
TRI_OPS = 45                   # one Möller–Trumbore test
SHADE_LANE_OPS = 2000          # K4 at NEE 1+1, an estimate from its source
SHADE_NEE_OPS = 600            # each further NEE sample (its fused BSDF eval)
PSNR_MIN, SMAPE_MAX = 40.0, 0.02            # cross-platform golden gate
FAST_PSNR, FAST_SMAPE = 45.0, 0.01          # same-platform fast gate


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations") for the work on the H100."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(fn, iters: int, warmup: bool = True) -> float:
    """Mean device time of fn() over `iters` calls (CUDA events, after
    one warm-up call unless warmup=False)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Capture:
    """Records the arguments of the first calls of kernel wrappers during
    one render (the inputs the main path gives each kernel), up to
    limits[name] calls per wrapper; with `during` (keys of STAGES), only
    the calls made inside all of those stages' functions. Captures nest."""
    MODULES = {"trace_dense": "rtxpt_tpu_torch.ops.mt_dense",
               "gather_rows": "rtxpt_tpu_torch.ops.gather",
               "gather_rows_interp": "rtxpt_tpu_torch.ops.gather",
               "shade_nee": "rtxpt_tpu_torch.pt.shade_kernel",
               "shade_nee_fill": "rtxpt_tpu_torch.pt.shade_kernel",
               "trace_bvh8": "rtxpt_tpu_torch.ops.traverse_bvh8",
               "trace_bvh8_sub": "rtxpt_tpu_torch.ops.traverse_bvh8"}
    # (module, function, which calls count: None for all): the realtime
    # frame's stages, as models/realtime.py calls them, and the visibility
    # traces that cast at least one ray
    STAGES = {"build": ("rtxpt_tpu_torch.pt.stableplanes",
                        "build_stable_planes", None),
              "fill": ("rtxpt_tpu_torch.pt.integrator", "render_paths",
                       None),
              "restir": ("rtxpt_tpu_torch.restir.di", "fused_final_shade",
                         None),
              "busy_anyhit": ("rtxpt_tpu_torch.ops.traverse", "trace_anyhit",
                              lambda kw: kw.get("active") is None
                              or bool(kw["active"].any()))}

    def __init__(self, limits: dict, during=()):
        import importlib
        self.limits = limits
        self.kernels = [(importlib.import_module(self.MODULES[name]), name)
                        for name in limits]
        self.stages = [(importlib.import_module(self.STAGES[s][0]),
                        *self.STAGES[s][1:]) for s in during]
        self.inside = {name: False for _, name, _ in self.stages}
        self.calls = {name: [] for name in limits}
        self.orig = []

    def __enter__(self):
        for mod, name, when in self.stages:
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))

            def staged(*args, _fn=fn, _name=name, _when=when, **kw):
                was = self.inside[_name]
                self.inside[_name] = _when is None or _when(kw)
                try:
                    return _fn(*args, **kw)
                finally:
                    self.inside[_name] = was
            setattr(mod, name, staged)
        for mod, name in self.kernels:
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))

            def wrapped(*args, _fn=fn, _name=name, **kw):
                if all(self.inside.values()) and \
                        len(self.calls[_name]) < self.limits[_name]:
                    self.calls[_name].append(
                        ([a.clone() if torch.is_tensor(a) else a
                          for a in args], dict(kw)))
                return _fn(*args, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.orig):
            setattr(mod, name, fn)


FIRST_BOUNCE = {"trace_dense": 3, "gather_rows": 16, "gather_rows_interp": 1,
                "shade_nee": 1}


def k1_work(args, kw, t, slot, worklists):
    """(bytes, ops) of one K1 launch: every active lane slab-tests the
    clusters of its tile's worklist, and tests the 64 rows of each cluster
    its box lets through (up to the lane's final t; for any-hit, up to the
    cluster of the first hit, in worklist order)."""
    from rtxpt_tpu_torch.ops import mt_dense
    from rtxpt_tpu_torch.ops.intersect import safe_inv
    aabb_c, tri9, o_c, d, tmax, act = args
    counts, order = worklists
    n, nc = o_c.shape[0], aabb_c.shape[0]
    nbytes = (aabb_c.numel() + tri9.numel() + counts.numel()
              + order.numel()) * 4 + n * (12 + 12 + 4 + 1 + 8)
    lim = tmax if kw["any_hit"] else t
    # rank[tile, c]: cluster c's place on the tile's list
    rank = torch.empty_like(order).scatter_(
        1, order.long(), torch.arange(nc, dtype=order.dtype,
                                      device=order.device).expand_as(order)
        .contiguous())
    passing = 0
    for c in range(0, n, 1 << 16):
        sl = slice(c, c + (1 << 16))
        lanes = torch.arange(c, min(c + (1 << 16), n), device=o_c.device)
        r = rank[lanes // mt_dense.TILE]
        inv = safe_inv(d[sl])[:, None]
        t0 = (aabb_c[None, :, 0:3] - o_c[sl, None]) * inv
        t1 = (aabb_c[None, :, 3:6] - o_c[sl, None]) * inv
        tn = torch.clamp(torch.amax(torch.minimum(t0, t1), -1), min=0.0)
        tf = torch.minimum(torch.amin(torch.maximum(t0, t1), -1),
                           lim[sl, None])
        m = (tn <= tf) & act[sl, None] \
            & (r < counts[lanes // mt_dense.TILE, None])
        if kw["any_hit"]:
            hit_c = torch.clamp(slot[sl], min=0).long() // mt_dense.CLUSTER
            last = torch.where(slot[sl] >= 0, r.gather(1, hit_c[:, None])[:, 0],
                               nc)
            m &= r <= last[:, None]
        passing += int(m.sum())
    tiles = torch.arange(n, device=o_c.device) // mt_dense.TILE
    slabs = int(counts.long()[tiles][act].sum())
    ops = slabs * SLAB_OPS + passing * mt_dense.CLUSTER * TRI_OPS
    return nbytes, ops


def check_k7(args, what) -> tuple:
    """K7 on one captured K1 trace's inputs: keys bit-equal to the plain
    version's, and counts/order equal to a stable argsort of them; the
    plain version is the keys and that sort -> (worklists, ms, plain ms,
    bytes, ops)."""
    from rtxpt_tpu_torch.ops import mt_dense as M
    from tools_torch.profile_mt_kernel import visits
    aabb_c, _, o_c, d, tmax, act = args

    def plain():
        keys = M.tile_keys_plain(aabb_c, o_c, d, tmax, act)
        return (keys, *M.worklists_from_keys(keys))

    k, counts, order = M.tile_keys(aabb_c, o_c, d, tmax, act)
    p, counts_p, order_p = plain()
    require(torch.equal(k.view(torch.int32), p.view(torch.int32)),
            f"K7 {what}: keys not bit-equal to the plain version")
    require(torch.equal(counts, counts_p) and torch.equal(order, order_p),
            f"K7 {what}: counts/order differ from the plain version's")
    ms = time_ms(lambda: M.tile_keys(aabb_c, o_c, d, tmax, act), 20)
    pms = time_ms(plain, 3)
    n, nc = o_c.shape[0], aabb_c.shape[0]
    nbytes = n * (12 + 12 + 4 + 1) + nc * 24 + (2 * k.numel()
                                                + counts.numel()) * 4
    # slab tests, and the bitonic sort's compare-exchanges (4 operations)
    steps = (nc - 1).bit_length()
    ops = int(act.sum()) * nc * SLAB_OPS \
        + k.shape[0] * (1 << steps) // 2 * steps * (steps + 1) // 2 * 4
    print(f"K7 {what}: keys bit-equal, worklists equal ({k.shape[0]} tiles "
          f"of {M.TILE} x {nc}), visits/tile {visits(counts)}; kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms, bound "
          f"{bound(nbytes, ops)[0]:.4f} ms", flush=True)
    return (counts, order), ms, pms, nbytes, ops


def check_kernels(results: dict):
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM, procedural

    w, h = 800, 600
    host = procedural.build_programmer_art().finish()
    cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                           nee_distant_samples=1, nee_local_samples=1)
    r = Renderer(host, procedural.default_camera(w, h), cfg,
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    with Capture(FIRST_BOUNCE) as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()

    # ---- K1: the first closest trace (camera rays), the second (one
    # bounce of scattered rays) and the first any-hit trace (NEE rays)
    closest = [c for c in cap.calls["trace_dense"] if not c[1]["any_hit"]]
    anyhit = [c for c in cap.calls["trace_dense"] if c[1]["any_hit"]]
    require(len(closest) >= 2 and anyhit, "K1: too few traces captured")
    results["bench"].update(check_dense(
        r.accel, [("camera", closest[0], True),
                  ("scattered", closest[1], False),
                  ("nee any-hit", anyhit[0], True)], "bench"))

    # ---- K2-K4 on the gathers and the shade pass of the first bounce;
    # K4 also at the goldens' NEE 2+2 (reference_config())
    results["bench"].update(check_surface_kernels(cap, "bench", w * h))
    r = Renderer(host, procedural.default_camera(w, h), reference_config(),
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    with Capture(FIRST_BOUNCE) as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    check_shade(*cap.calls["shade_nee"][0], "reference_config()")


def check_dense(accel, traces, label) -> dict:
    """K7 and K1 on captured traces [(what, (args, kw), timed)]: K7 as
    check_k7 says; K1 (walking K7's worklists) against the plain version
    over all clusters: the same winner (closest) or occlusion flag
    (any-hit) on >= 99.99% of the active lanes and t/u/v within rtol 1e-5
    / atol 1e-6 where the winners agree; kernel and plain times and the
    bound summed over the timed traces -> {"mt_dense": ..., "tile_keys":
    ...}."""
    from rtxpt_tpu_torch.ops import mt_dense
    k1_ms = k1_plain_ms = k1_err = 0.0
    k1_bytes = k1_ops = 0
    k7 = [0.0, 0.0, 0, 0]                    # ms, plain ms, bytes, ops
    for what, (args, kw), timed in traces:
        wl, *k7_res = check_k7(args, f"{label} {what}")
        if timed:
            k7 = [a + b for a, b in zip(k7, k7_res)]
        what = f"K1 {label} {what}"
        aabb_c, tri9, o_c, d, tmax, act = args
        t_k, s_k = mt_dense.trace_dense(*args, **kw, worklists=wl)
        t_p, s_p = mt_dense.trace_dense_plain(*args, **kw)
        torch.cuda.synchronize()
        lanes = int(act.sum())
        require(lanes > 0, f"{what}: no active lane")
        if kw["any_hit"]:
            agree = float(((s_k >= 0) == (s_p >= 0))[act].float().mean())
            print(f"{what}: {act.numel()} lanes ({lanes} active), "
                  f"occlusion flag equal on {agree:.6%}")
            require(agree >= 0.9999, f"{what}: agreement {agree}")
        else:
            same = (s_k == s_p) & act
            agree = float(same[act].float().mean())
            hk = mt_dense.resolve_hits(accel, o_c, d, t_k, s_k)
            hp = mt_dense.resolve_hits(accel, o_c, d, t_p, s_p)
            m = same & (s_k >= 0)
            err = max(float((hk.t - hp.t)[m].abs().max()),
                      float((hk.bary - hp.bary)[m].abs().max()))
            k1_err = max(k1_err, err)
            ok_tuv = torch.allclose(hk.t[m], hp.t[m], rtol=1e-5, atol=1e-6) \
                and torch.allclose(hk.bary[m], hp.bary[m], rtol=1e-5,
                                   atol=1e-6)
            print(f"{what}: {act.numel()} lanes ({lanes} active), same "
                  f"winner on {agree:.6%}, t/u/v max |diff| {err:.3g}")
            require(agree >= 0.9999, f"{what}: winner agreement {agree}")
            require(ok_tuv, f"{what}: t/u/v outside rtol 1e-5 / atol 1e-6")
        if timed:
            ms = time_ms(lambda: mt_dense.trace_dense(*args, **kw,
                                                      worklists=wl), 20)
            pms = time_ms(lambda: mt_dense.trace_dense_plain(*args, **kw), 2)
            nb, ops = k1_work(args, kw, t_k, s_k, wl)
            print(f"{what}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {bound(nb, ops)[0]:.4f} ms", flush=True)
            k1_ms += ms
            k1_plain_ms += pms
            k1_bytes += nb
            k1_ops += ops
    b_ms, b_by = bound(k1_bytes, k1_ops)
    k7_b, k7_by = bound(k7[2], k7[3])
    return {"mt_dense": dict(max_abs_err=k1_err, ms=k1_ms,
                             plain_ms=k1_plain_ms, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by),
            "tile_keys": dict(max_abs_err=0.0, ms=k7[0], plain_ms=k7[1],
                              library_ms=None, bound_ms=k7_b,
                              bound_by=k7_by)}


def check_gathers(calls, label, lanes=None) -> dict:
    """K2 on each distinct captured gather (table, index count), with
    `lanes` rows when given: bit-equal to the plain version; kernel, plain
    and torch.index_select times summed over them."""
    from rtxpt_tpu_torch.ops import gather
    ms_sum = plain_sum = lib_sum = 0.0
    nbytes = 0
    seen = set()
    for args, _ in calls:
        table, idx = args
        key = (tuple(table.shape), table.dtype, idx.numel())
        if (lanes is not None and idx.numel() != lanes) or key in seen:
            continue
        seen.add(key)
        got = gather.gather_rows(table, idx)
        ref = gather.gather_rows_plain(table, idx)
        require(torch.equal(got, ref), f"K2 {label}: gather of a "
                f"{tuple(table.shape)} table not bit-equal")
        ms = time_ms(lambda: gather.gather_rows(table, idx), 50)
        pms = time_ms(lambda: gather.gather_rows_plain(table, idx), 50)
        # the library call: torch.index_select on the clamped indices
        safe = torch.clamp(idx.reshape(-1), 0, table.shape[0] - 1)
        lms = time_ms(lambda: torch.index_select(table, 0, safe), 50)
        uniq = torch.unique(safe).numel()
        nbytes += (uniq + idx.numel()) * table.shape[1] \
            * table.element_size() + idx.numel() * idx.element_size()
        print(f"K2 {label} {tuple(table.shape)} {table.dtype} x "
              f"{idx.numel()} rows: bit-equal, kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, index_select {lms:.4f} ms")
        ms_sum += ms
        plain_sum += pms
        lib_sum += lms
    require(len(seen) >= 5, f"K2 {label}: too few gathers captured")
    b_ms, b_by = bound(nbytes, 0)
    return dict(max_abs_err=0.0, ms=ms_sum, plain_ms=plain_sum,
                library_ms=lib_sum, bound_ms=b_ms, bound_by=b_by)


def check_interp(args, label) -> dict:
    """K3 on one captured barycentric blend, within rtol/atol 1e-6."""
    from rtxpt_tpu_torch.ops import gather
    got = gather.gather_rows_interp(*args)
    ref = gather.gather_rows_interp_plain(*args)
    err = float((got - ref).abs().max())
    require(torch.allclose(got, ref, rtol=1e-6, atol=1e-6),
            f"K3 {label} outside rtol 1e-6 / atol 1e-6 (max |diff| {err})")
    ms = time_ms(lambda: gather.gather_rows_interp(*args), 50)
    pms = time_ms(lambda: gather.gather_rows_interp_plain(*args), 50)
    table, i3, w3 = args
    nb = (torch.unique(i3).numel() + i3.shape[0]) * table.shape[1] * 4 \
        + i3.numel() * i3.element_size() + w3.numel() * 4
    b_ms, b_by = bound(nb, i3.shape[0] * table.shape[1] * 5)
    print(f"K3 {label} {i3.shape[0]} lanes: max |diff| {err:.3g}, kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)


def check_surface_kernels(cap, label, lanes=None, fill=False) -> dict:
    """K2, K3 and K4 (fill: K4 FILL) on the calls a Capture of one first
    bounce recorded -> {kernel name: result}; raises where a kernel
    disagrees."""
    shade = "shade_nee_fill" if fill else "shade_nee"
    require(cap.calls["gather_rows_interp"] and cap.calls[shade],
            f"{label}: no K3 or {shade} launch captured")
    out = {"gather_rows": check_gathers(cap.calls["gather_rows"], label,
                                        lanes),
           "gather_rows_interp": check_interp(
               cap.calls["gather_rows_interp"][0][0], label)}
    args, kw = cap.calls[shade][0]
    out[shade] = check_shade(args, kw, label, fill=fill)
    return out


def check_shade(args, kw, label="bench", fill=False) -> dict:
    """K4 (fill: its FILL variant) against its plain version: lobe and
    flags equal on >= 99.99% of lanes, the rest within rtol 2e-4 / atol
    2e-5 on those lanes (FILL: max |diff| < 1e-5); both timed."""
    from rtxpt_tpu_torch.pt import shade_kernel as SK
    kernel = SK.shade_nee_fill if fill else SK.shade_nee
    got = kernel(*args, **kw)
    ref = SK.shade_nee_plain(*args, fill=fill, **kw)
    L = SK.out_layout(kw["nee_distant"], kw["nee_local"], fill)
    flags = ["lobe", "scatter_valid", "will_scatter", "rr_kill",
             "non_delta_scatter"] + [f"nee_need{i}" for i in range(
                 kw["nee_distant"] + kw["nee_local"])]
    rows = [L.map[f][0] for f in flags]
    same = (got[rows] == ref[rows]).all(0)
    agree = float(same.float().mean())
    err = float((got[:, same] - ref[:, same]).abs().max())
    close = torch.allclose(got[:, same], ref[:, same], rtol=2e-4, atol=2e-5)
    what = f"K4{' FILL' if fill else ''} {label} NEE " \
        f"{kw['nee_distant']}+{kw['nee_local']}"
    print(f"{what}, {got.shape[1]} lanes: lobe/flags equal on "
          f"{agree:.6%}, max |diff| {err:.3g}")
    require(agree >= 0.9999, f"{what}: lobe/flag agreement {agree}")
    require(close, f"{what}: outside rtol 2e-4 / atol 2e-5")
    if fill:
        require(err < 1e-5, f"{what}: max |diff| {err} >= 1e-5")
    ms = time_ms(lambda: kernel(*args, **kw), 20)
    pms = time_ms(lambda: SK.shade_nee_plain(*args, fill=fill, **kw), 5)
    planes, n = args[0], args[0].shape[1]
    ops = n * (SHADE_LANE_OPS + SHADE_NEE_OPS
               * (kw["nee_distant"] + kw["nee_local"] - 2))
    b_ms, b_by = bound((planes.shape[0] + L.rows) * n * 4, ops)
    print(f"{what}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {planes.shape[0]} + {L.rows} rows)")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)


def render(w, h, spp, device, cfg=None, env_height=64):
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    host = procedural.build_programmer_art().finish()
    r = Renderer(host, procedural.default_camera(w, h),
                 cfg or reference_config(),
                 env_radiance=EM.bake_procedural_sky(height=env_height),
                 device=device)
    hdr = r.render(w, h, spp)
    return hdr, r.tonemapped(hdr)


def check_goldens():
    from rtxpt_tpu_torch.utils import image as IM
    imgs = {}
    for w, h, spp in ((64, 48, 2), (160, 120, 8)):
        hdr, img = render(w, h, spp, "cuda")
        img = img.cpu().numpy()
        require(np.isfinite(img).all() and img.shape == (h, w, 3),
                f"{w}x{h}: non-finite or misshapen image")
        m = IM.compare(img, IM.load_png(
            f"assets/golden_programmer_art_{w}x{h}_{spp}spp.png"))
        fast = m["psnr"] > FAST_PSNR and m["smape"] < FAST_SMAPE
        print(f"golden {w}x{h} {spp}spp: PSNR {m['psnr']:.2f} dB, SMAPE "
              f"{m['smape']:.5f} (gate {PSNR_MIN} dB / {SMAPE_MAX}; fast "
              f"gate {FAST_PSNR} dB / {FAST_SMAPE}: "
              f"{'met' if fast else 'not met'})")
        require(m["psnr"] > PSNR_MIN and m["smape"] < SMAPE_MAX,
                f"golden {w}x{h} {spp}spp outside the gate: {m}")
        imgs[(w, h)] = img
    _, cpu = render(64, 48, 2, "cpu")
    m = IM.compare(imgs[(64, 48)], cpu.numpy())
    print(f"GPU vs CPU (plain) 64x48 2spp: PSNR {m['psnr']:.2f} dB, SMAPE "
          f"{m['smape']:.5f}")
    require(m["psnr"] > PSNR_MIN, f"GPU vs CPU render: {m}")


def bench(card: str) -> dict:
    """The bench workload; returns its launch counts."""
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.ops import cuda_lib
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    w, h, spp = 800, 600, 8
    host = procedural.build_programmer_art().finish()
    cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                           nee_distant_samples=1, nee_local_samples=1)
    r = Renderer(host, procedural.default_camera(w, h), cfg,
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    r.render(w, h, spp)                      # warm-up (allocator, caches)
    torch.cuda.synchronize()
    r.reset_accumulation()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    hdr = r.render(w, h, spp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    out = hdr.cpu().numpy()
    require(out.shape == (h, w, 3) and np.isfinite(out).all()
            and out.mean() > 0.0, "bench render: bad output")
    mpaths = w * h * spp / wall / 1e6
    print(f"bench {w}x{h} {spp}spp NEE 1+1, 6 bounces: {wall * 1e3:.1f} ms "
          f"wall, {mpaths:.3f} Mpaths/s on {card}; launches {counts}")
    for name in BENCH_PATH:
        require(counts[KERNELS[name][0]] > 0,
                f"{name} was not launched on the bench path")
    return {name: counts.get(KERNELS[name][0], 0) for name in KERNELS}


class VisitCount:
    """Counts the tiles and worklist visits of every dense trace while
    active (wraps mt_dense.tile_worklists; the sums stay on the device)."""

    def __enter__(self):
        from rtxpt_tpu_torch.ops import mt_dense as M
        self.mod, self.orig = M, M.tile_worklists
        self.visits, self.tiles = 0, 0

        def counted(*args, **kw):
            counts, order = self.orig(*args, **kw)
            self.visits = self.visits + counts.sum()
            self.tiles += counts.numel()
            return counts, order
        M.tile_worklists = counted
        return self

    def __exit__(self, *exc):
        self.mod.tile_worklists = self.orig

    def per_tile(self) -> float:
        return float(self.visits) / max(self.tiles, 1)


def sorted_bench(card: str):
    """The bench workload unsorted and under wavefront_sort="raystream"
    (each with its launch counts set to 0 just before): both walls and
    visits per tile; the sorted render must launch K1 and K7 and equal the
    unsorted one to the tolerance of tests/test_raystream_sort.py."""
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.ops import cuda_lib
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    w, h, spp = 800, 600, 8
    host = procedural.build_programmer_art().finish()
    imgs = {}
    for sort in ("none", "raystream"):
        cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                               nee_distant_samples=1, nee_local_samples=1,
                               wavefront_sort=sort)
        r = Renderer(host, procedural.default_camera(w, h), cfg,
                     env_radiance=EM.bake_procedural_sky(height=64),
                     device="cuda")
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        with VisitCount() as vc:
            t0 = time.perf_counter()
            hdr = r.render(w, h, spp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = cuda_lib.launch_counts()
        imgs[sort] = hdr.cpu().numpy()
        print(f"bench wavefront_sort={sort}: {wall * 1e3:.1f} ms wall "
              f"({w * h * spp / wall / 1e6:.3f} Mpaths/s) on {card}; "
              f"visits/tile {vc.per_tile():.3f} over {vc.tiles} tiles; K1 "
              f"{counts['mt_dense']}, K7 {counts['tile_keys']} launches",
              flush=True)
        for name in ("mt_dense", "tile_keys"):
            require(counts[name] > 0, f"{name} was not launched under "
                    f"wavefront_sort={sort}")
    a, b = imgs["none"], imgs["raystream"]
    diff = np.abs(a - b)
    print(f"raystream vs unsorted: max |diff| {diff.max():.3g}, pixels "
          f"outside rtol 1e-5 / atol 1e-6: "
          f"{int((diff > 1e-6 + 1e-5 * np.abs(a)).any(-1).sum())} of "
          f"{w * h}", flush=True)
    require(np.isfinite(b).all() and np.allclose(b, a, rtol=1e-5, atol=1e-6),
            "raystream render differs from the unsorted one")


def labs(results: dict) -> dict:
    """The labs phase (7.): K9's modes on the bench camera rays and every
    K8 micro-kernel against its plain version -> results["labs"]; returns
    the labs' kernels (no main path runs them) as KERNELS describes
    kernels."""
    from rtxpt_tpu_torch.ops import mt_dense as M
    from tools_torch import kernel_lab as KL
    from tools_torch import profile_mt_kernel as PM
    args, _ = PM.capture_traces()["camera"]
    aabb_c, _, o_c, d, tmax, act = args
    modes = PM.run_modes(args)
    print("K9 modes on the bench camera rays (ms, agreement with the plain "
          "version): " + ", ".join(f"{m} {ms:.4f} ({agree:.6%})"
                                   for m, (ms, agree) in modes.items()),
          flush=True)
    wl = M.tile_worklists(aabb_c, o_c, d, tmax, act)
    pms = time_ms(lambda: PM.gate_visits_plain(aabb_c, o_c, d, tmax, act,
                                               wl), 3)
    tiles = torch.arange(o_c.shape[0], device=o_c.device) // M.TILE
    nb = o_c.shape[0] * (12 + 12 + 4 + 1 + 4) + aabb_c.numel() * 4 \
        + (wl[0].numel() + wl[1].numel()) * 4
    b_ms, b_by = bound(nb, int(wl[0].long()[tiles][act].sum()) * SLAB_OPS)
    kernels = {"mt_dense_gate": ("mt_dense_variant", PM.SOURCE,
                                 PM.REPLACES)}
    results["labs"]["mt_dense_gate"] = dict(
        max_abs_err=0.0, ms=modes["gate"][0], plain_ms=pms, library_ms=None,
        bound_ms=b_ms, bound_by=b_by,
        modes_ms={m: ms for m, (ms, _) in modes.items()})
    table = KL.make_table("cuda")
    for name in KL.KERNELS:
        err = KL.check(name, table)
        ms = KL.time_ms(lambda: KL.run(name, table, KL.CHECK_ITERS))
        pms = KL.time_ms(lambda: KL.plain(name, table, KL.CHECK_ITERS), 1)
        full = KL.time_ms(lambda: KL.run(name, table, KL.ITERS))
        nb = KL.LANES * 4 + (table.numel() * 4 if name == "row_fetch" else 0)
        b_ms, b_by = bound(nb, KL.OPS[name] * KL.LANES * KL.CHECK_ITERS)
        print(f"K8 {name}: max |diff| {err:.3g} at {KL.CHECK_ITERS} "
              f"iterations (kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{b_ms:.4f} ms); {full * 1e3 / KL.ITERS:.4f} us/iter over "
              f"{KL.LANES} lanes at {KL.ITERS} iterations", flush=True)
        kernels[f"lab_{name}"] = ("kernel_lab", KL.SOURCE, KL.REPLACES[name])
        results["labs"][f"lab_{name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
            bound_ms=b_ms, bound_by=b_by,
            us_per_iter=full * 1e3 / KL.ITERS)
    return kernels


def bvh8_work(args, stats, stacked: bool):
    """(bytes, ops) of one K5/K6 launch: the active lanes' rays (and
    subtree index), every lane's t_max and active flag, the outputs, and
    each table row the plain version fetched, once (a node row's 56
    floats; a leaf's triangles at 9 floats and one opacity mask each);
    operations from the plain version's counts of node rows and leaf
    triangles."""
    o, act = args[3 if stacked else 2], args[-1]
    n, a = o.shape[0], int(act.sum())
    nbytes = n * (1 + 4 + 16) + a * (24 + (4 if stacked else 0)) \
        + stats["distinct_node_rows"] * 56 * 4 \
        + stats["distinct_leaf_tris"] * (9 + 1) * 4
    ops = stats["node_rows"] * NODE_ROW_OPS + stats["leaf_tris"] * TRI_OPS
    return nbytes, ops


def check_bvh8(calls, label, stacked):
    """K6 (stacked) or K5 on the captured launches of one trace: kernel
    against plain version (agreement, max |diff|), both timed; returns
    (agreeing lanes, active lanes, max |diff|, ms, plain ms, bytes, ops,
    launches with no active lane, row-traffic bytes)."""
    from rtxpt_tpu_torch.ops import traverse_bvh8 as T8
    kernel = T8.trace_bvh8_sub if stacked else T8.trace_bvh8
    agree = lanes = empty = 0
    err = ms = pms = nbytes = ops = traffic = 0.0
    for args, kw in calls:
        act = args[-1]
        n_act = int(act.sum())
        empty += n_act == 0
        if stacked:
            tables, omm, sub, o, d, tmax, _ = args
            plain_args = (tables, omm, o, d, tmax, act, sub)
        else:
            plain_args = tuple(args)
        stats = {}
        t_k, s_k, uv_k = kernel(*args, **kw)
        t_p, s_p, uv_p = T8.trace_bvh8_plain(*plain_args, **kw, stats=stats)
        torch.cuda.synchronize()
        if kw["any_hit"]:
            agree += int(((s_k >= 0) == (s_p >= 0))[act].sum())
        else:
            same = s_k == s_p
            agree += int(same[act].sum())
            m = same & (s_k >= 0)
            if bool(m.any()):
                err = max(err, float((t_k - t_p)[m].abs().max()),
                          float((uv_k - uv_p)[m].abs().max()))
                require(torch.allclose(t_k[m], t_p[m], rtol=1e-5, atol=1e-6)
                        and torch.allclose(uv_k[m], uv_p[m], rtol=1e-5,
                                           atol=1e-6),
                        f"{label}: t/u/v outside rtol 1e-5 / atol 1e-6")
        lanes += n_act
        ms += time_ms(lambda: kernel(*args, **kw), 20)
        pms += time_ms(lambda: T8.trace_bvh8_plain(*plain_args, **kw), 1,
                       warmup=False)
        nb, op = bvh8_work(args, stats, stacked)
        nbytes += nb
        ops += op
        traffic += stats["node_rows"] * 56 * 4 + stats["leaf_tris"] * 40
    return agree, lanes, err, ms, pms, nbytes, ops, empty, traffic


def check_two_level(traces, label) -> dict:
    """K6 and K5 on captured two-level traces [(what, probe call, sweep
    calls, timed)]: the same prim (closest) or occlusion flag (any-hit) on
    >= 99.99% of the active lanes -> {kernel name: result}, times and
    bound summed over the timed traces."""
    tot = {"bvh8_trace_sub": [0] * 9, "bvh8_trace": [0] * 9}
    for what, probe, sweeps, timed in traces:
        for name, calls, stacked in (("bvh8_trace_sub", [probe], True),
                                     ("bvh8_trace", sweeps, False)):
            tag = f"{name} {label} {what}"
            res = check_bvh8(calls, tag, stacked)
            agree, lanes, err, ms, pms, nb, ops, empty, traffic = res
            frac = agree / max(lanes, 1)
            same = "occlusion" if calls[0][1]["any_hit"] else "prim"
            print(f"{tag}: {len(calls)} launch(es) over "
                  f"{calls[0][0][-1].numel()} lanes, {lanes} active lanes "
                  f"(plain on the full wavefront), {empty} with no active "
                  f"lane; same {same} on {frac:.6%}, t/u/v max |diff| "
                  f"{err:.3g}; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {bound(nb, ops)[0]:.4f} ms, row traffic "
                  f"{traffic / 1e9:.3f} GB "
                  f"({traffic / HBM_BYTES_PER_S * 1e3:.4f} ms at HBM rate)",
                  flush=True)
            require(lanes == 0 or frac >= 0.9999,
                    f"{tag}: agreement {frac}")
            if timed:
                acc = tot[name]
                for j, v in enumerate((agree, lanes, err, ms, pms, nb, ops,
                                       empty, traffic)):
                    acc[j] = max(acc[j], v) if j == 2 else acc[j] + v
    out = {}
    for name, acc in tot.items():
        require(acc[1] > 0, f"{label}: no active lane for {name}")
        b_ms, b_by = bound(acc[5], acc[6])
        out[name] = dict(max_abs_err=acc[2], ms=acc[3], plain_ms=acc[4],
                         library_ms=None, bound_ms=b_ms, bound_by=b_by)
    return out


def build_city():
    from rtxpt_tpu_torch.scene import procedural
    return procedural.build_city().finish()


def city(results: dict, card: str, host, geometry_s: float) -> dict:
    """The city phase (5.) on the host geometry build_city() made in
    `geometry_s` seconds; returns the launch counts of its render."""
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.ops import bvh2l, cuda_lib
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    from rtxpt_tpu_torch.utils import image as IM
    w, h, spp = 1920, 1080, 2
    cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                           nee_distant_samples=1, nee_local_samples=1)
    env = EM.bake_procedural_sky(height=64)
    t0 = time.perf_counter()
    r = Renderer(host, procedural.city_camera(w, h), cfg, env_radiance=env,
                 device="cuda")
    torch.cuda.synchronize()
    renderer_s = time.perf_counter() - t0
    tl = r.accel
    require(isinstance(tl, bvh2l.BVH8TwoLevel),
            "city: not on the two-level tier")
    k = tl.num_subtrees
    print(f"city: {host['indices'].shape[0]} triangles, two-level BVH8 "
          f"K={k} S={tl.rows} ({tl.sub_tables.numel() * 4 / 1e6:.1f} MB), "
          f"host build {geometry_s + renderer_s:.2f} s (geometry "
          f"{geometry_s:.2f} s, Renderer {renderer_s:.2f} s)", flush=True)
    require(k >= bvh2l.PROBE_MIN_SUBTREES, "city: the probe does not engage")

    # K6 and K5 on the first bounce of a 1-spp render: the probes and
    # sweeps of the camera rays, their NEE rays and the scattered rays
    # (ms sums camera + NEE, as K1's); K2-K4 on its gathers and shade pass
    with Capture(dict(FIRST_BOUNCE, trace_bvh8_sub=3,
                      trace_bvh8=3 * k)) as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    probes, sweeps = cap.calls["trace_bvh8_sub"], cap.calls["trace_bvh8"]
    require(len(probes) == 3 and len(sweeps) == 3 * k,
            "city: too few traces captured")
    results["city"].update(check_two_level(
        [(what, probes[i], sweeps[i * k:(i + 1) * k], what != "scattered")
         for i, what in enumerate(("camera", "nee any-hit", "scattered"))],
        "city"))
    results["city"].update(check_surface_kernels(cap, "city"))
    del cap, probes, sweeps          # the captured inputs

    # the main path: 1920x1080, 2 spp as one regenerating chunk
    r.render(w, h, spp)                      # warm-up
    torch.cuda.synchronize()
    r.reset_accumulation()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    hdr = r.render(w, h, spp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    out = hdr.cpu().numpy()
    require(out.shape == (h, w, 3) and np.isfinite(out).all()
            and out.mean() > 0.0, "city render: bad output")
    print(f"city {w}x{h} {spp}spp NEE 1+1, 6 bounces: {wall * 1e3:.1f} ms "
          f"wall, {w * h * spp / wall / 1e6:.3f} Mpaths/s on {card}; "
          f"launches {counts}", flush=True)
    for name in CITY_PATH:
        require(counts[KERNELS[name][0]] > 0,
                f"{name} was not launched on the city path")

    # the port on the card against the port's plain versions on the CPU
    imgs = []
    for device in ("cuda", "cpu"):
        rs = Renderer(host, procedural.city_camera(64, 36), cfg,
                      env_radiance=env, device=device)
        imgs.append(rs.tonemapped(rs.render(64, 36, 1)).cpu().numpy())
    require(np.isfinite(imgs[0]).all(), "city 64x36: non-finite image")
    m = IM.compare(imgs[0], imgs[1])
    print(f"city GPU vs CPU (plain) 64x36 1spp: PSNR {m['psnr']:.2f} dB, "
          f"SMAPE {m['smape']:.5f}")
    require(m["psnr"] > PSNR_MIN, f"city GPU vs CPU render: {m}")
    return {name: counts.get(KERNELS[name][0], 0) for name in KERNELS}


def capture_realtime_frame(r, w, h):
    """Render one frame of the realtime renderer `r` with the first
    launches of each stage captured -> (trace limits, the first FILL
    bounce's Capture, [(trace, Capture, any-hit)]): the first FILL bounce
    (its gathers and K4 FILL), the BUILD pass's first trace (the camera
    rays), the first FILL NEE trace that casts a ray (the first bounce's
    casts none where ReSTIR DI owns the base) and the fused ReSTIR DI + GI
    final shade's visibility trace. A two-level trace is one K6 probe and
    one K5 sweep per subtree."""
    from rtxpt_tpu_torch.ops import bvh2l
    if isinstance(r.accel, bvh2l.BVH8TwoLevel):
        traces = {"trace_bvh8_sub": 1, "trace_bvh8": r.accel.num_subtrees}
    else:
        traces = {"trace_dense": 1}
    with Capture(traces, during=("build",)) as build, \
            Capture(dict(gather_rows=16, gather_rows_interp=1,
                         shade_nee_fill=1), during=("fill",)) as fill, \
            Capture(traces, during=("fill", "busy_anyhit")) as nee, \
            Capture(traces, during=("restir", "busy_anyhit")) as restir:
        r.render_frame(w, h)
        torch.cuda.synchronize()
    return traces, fill, [("BUILD camera", build, False),
                          ("FILL NEE", nee, True),
                          ("ReSTIR visibility", restir, True)]


def check_realtime_kernels(r, w, h, label) -> dict:
    """Every kernel of a realtime path against its plain version on the
    launches capture_realtime_frame() records (K4 FILL on all w*h lanes of
    the first FILL bounce) -> {kernel name: result}."""
    traces, fill, stages = capture_realtime_frame(r, w, h)
    for what, cap, any_hit in stages:
        for name, n in traces.items():
            require(len(cap.calls[name]) == n,
                    f"{label} {what}: {len(cap.calls[name])} {name} calls "
                    f"captured, not {n}")
            require(cap.calls[name][0][1]["any_hit"] == any_hit,
                    f"{label} {what}: the first trace is not "
                    f"{'any-hit' if any_hit else 'closest-hit'}")
    require(fill.calls["shade_nee_fill"], f"{label}: no FILL launch")
    lanes = fill.calls["shade_nee_fill"][0][0][0].shape[1]
    require(lanes == w * h, f"{label}: the first FILL bounce has {lanes} "
            f"lanes, not {w * h}")
    if "trace_dense" in traces:
        out = check_dense(r.accel, [(what, cap.calls["trace_dense"][0], True)
                                    for what, cap, _ in stages], label)
    else:
        out = check_two_level(
            [(what, cap.calls["trace_bvh8_sub"][0], cap.calls["trace_bvh8"],
              True) for what, cap, _ in stages], label)
    out.update(check_surface_kernels(fill, label, fill=True))
    return out


def realtime_frames(r, w, h, label, card, path, warmups=2,
                    frames=3) -> dict:
    """`warmups` frames (the no-history and the history variant: 2 from a
    new renderer), then `frames` timed frames with the launch counters set
    to 0 just before, each ending in a device synchronize; requires the
    kernels of `path` to have launched and the last frame to be finite
    and not black. Returns the counts."""
    from rtxpt_tpu_torch.ops import cuda_lib
    for _ in range(warmups):
        r.render_frame(w, h)
        torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    walls, fills = [], []
    for _ in range(frames):
        t0 = time.perf_counter()
        img = r.render_frame(w, h)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        fills.append(cuda_lib.launch_counts()["shade_nee_fill"]
                     - sum(fills))
    counts = cuda_lib.launch_counts()
    out = img.cpu().numpy()
    require(out.shape == (h, w, 3) and np.isfinite(out).all()
            and out.mean() > 0.0, f"realtime {label}: bad frame")
    ms = [x * 1e3 for x in walls]
    print(f"realtime {label} {w}x{h}: {sum(ms) / len(ms):.1f} ms/frame "
          f"(frames {', '.join(f'{x:.1f}' for x in ms)} ms; FILL bounces "
          f"{fills}) on {card}; launches over {frames} frames {counts}",
          flush=True)
    for name in path:
        require(counts[KERNELS[name][0]] > 0,
                f"{name} was not launched on the realtime {label} path")
    return {name: counts.get(KERNELS[name][0], 0) for name in KERNELS}


def realtime(results: dict, card: str, host_city) -> dict:
    """The realtime phase (6.); returns the launch counts of its timed
    frames by path."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import (Renderer, realtime_config,
                                                 reference_config)
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    from rtxpt_tpu_torch.utils import image as IM
    launches = {}
    # ---- the city at 1920x1080: K4 FILL on the first FILL bounce, then
    # the timed frames
    w, h = 1920, 1080
    t0 = time.perf_counter()
    r = RealtimeRenderer(host_city, procedural.city_camera(w, h),
                         device="cuda")
    torch.cuda.synchronize()
    print(f"realtime city: renderer built in {time.perf_counter() - t0:.2f}"
          " s", flush=True)
    results["realtime_city"].update(
        check_realtime_kernels(r, w, h, "realtime city"))
    torch.cuda.empty_cache()
    # the captured frame was the no-history warm-up
    launches["realtime_city"] = realtime_frames(r, w, h, "city", card,
                                                RT_CITY_PATH, warmups=1)
    del r
    torch.cuda.empty_cache()

    # ---- programmer-art at 640x360 (the bench's realtime case)
    host = procedural.build_programmer_art().finish()
    w, h = 640, 360
    r = RealtimeRenderer(host, procedural.default_camera(w, h),
                         device="cuda")
    results["realtime_360p"].update(
        check_realtime_kernels(r, w, h, "realtime 360p"))
    launches["realtime_360p"] = realtime_frames(r, w, h, "programmer-art",
                                                card, RT_ART_PATH, warmups=1)

    # ---- the port on the card against the port on the CPU
    imgs = []
    for device in ("cuda", "cpu"):
        rs = RealtimeRenderer(host, procedural.default_camera(64, 48),
                              device=device)
        for _ in range(3):
            img = rs.render_frame(64, 48)
        imgs.append(rs.tonemapped(img).cpu().numpy())
    require(np.isfinite(imgs[0]).all(), "realtime 64x48: non-finite frame")
    m = IM.compare(imgs[0], imgs[1])
    print(f"realtime GPU vs CPU (plain) 64x48, frame 3: PSNR "
          f"{m['psnr']:.2f} dB, SMAPE {m['smape']:.5f}", flush=True)
    require(m["psnr"] > PSNR_MIN, f"realtime GPU vs CPU: {m}")

    # ---- the estimator oracle (tests/test_ref_vs_realtime.py) on the card
    w, h, n = 48, 32, 32
    cam = procedural.default_camera(w, h)
    env = EM.bake_procedural_sky(height=32, sun_radiance=(40.0, 38.0, 33.0))
    common = dict(max_bounces=4, max_diffuse_bounces=3,
                  nee_distant_samples=1, nee_local_samples=1,
                  enable_russian_roulette=False)
    ref = Renderer(host, cam, reference_config(**common), env_radiance=env,
                   device="cuda").render(w, h, n, jitter_aa=False)
    rt = RealtimeRenderer(host, cam, realtime_config(
        use_restir_di=False, use_restir_gi=False, denoiser_enabled=False,
        realtime_noise=False, use_stable_planes=True, **common),
        env_radiance=env, device="cuda")
    acc = torch.zeros((h, w, 3), device="cuda")
    for i in range(n):
        rt.frame_index = i
        acc += rt.render_frame(w, h, denoise=False, taa=False)
    ref, rt_img = ref.cpu().numpy(), (acc / n).cpu().numpy()
    blocks = lambda a: a.reshape(h // 8, 8, w // 8, 8, 3).mean((1, 3, 4))
    b_ref, b_rt = blocks(ref), blocks(rt_img)
    med = float(np.median(np.abs(b_ref - b_rt)
                          / (0.5 * (b_ref + b_rt) + 5e-2)))
    rel_mean = abs(ref.mean() - rt_img.mean()) / max(ref.mean(),
                                                     rt_img.mean())
    print(f"ref-vs-realtime {w}x{h}, {n} frames vs {n} spp: median block "
          f"error {med:.4f} (< 0.25), means {ref.mean():.5f} / "
          f"{rt_img.mean():.5f} ({rel_mean:.3%}, < 10%)", flush=True)
    require(med < 0.25 and rel_mean < 0.10, "ref-vs-realtime oracle failed")
    return launches


def phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # exact sobol matmul
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from rtxpt_tpu_torch.ops import cuda_lib
    from tools_torch import kernel_lab
    t0 = time.time()
    # the renderer's library and the K8 lab's, every nvcc started together
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(cuda_lib.lib), pool.submit(kernel_lab.library)]:
            f.result()
    print(f"built CUDA kernels in {time.time() - t0:.1f} s "
          f"({cuda_lib.build()} and the lab's)", flush=True)

    # each path's kernel checks, {path: {kernel name: result}}
    results = {p: {} for p in PATHS}
    results["labs"] = {}
    launches = {}
    phase("kernels K1-K4, K7", check_kernels, results)
    phase("goldens", check_goldens)
    launches["bench"] = phase("bench", bench, card)
    phase("bench raystream", sorted_bench, card)
    t0 = time.perf_counter()
    host_city = build_city()
    geometry_s = time.perf_counter() - t0
    launches["city"] = phase("city", city, results, card, host_city,
                             geometry_s)
    launches.update(phase("realtime", realtime, results, card, host_city))
    lab_kernels = phase("labs K8, K9", labs, results)
    for p, names in PATHS.items():
        missing = [n for n in names if n not in results[p]]
        require(not missing, f"{p}: {missing} not checked at this path's "
                "shapes")
    kernels = []
    for name, (_, src, rep) in {**KERNELS, **lab_kernels}.items():
        # the top-level numbers are those of the first path that checks
        # the kernel (K1-K4, K7: the bench; K5, K6: the city; K4 FILL: the
        # realtime city; K8, K9: the labs); by_path holds every path's
        path = next(p for p in results if name in results[p])
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=sum(c.get(name, 0) for c in launches.values()),
            launches_by_path={p: c.get(name, 0)
                              for p, c in launches.items()},
            measured_on=path, **{key: results[path][name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            by_path={p: results[p][name] for p in results
                     if name in results[p]}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
