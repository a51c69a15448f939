#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rtxpt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. print the card (nvidia-smi name, power limit); build the CUDA kernels
     from csrc/ with nvcc for sm_90a;
  2. hold each kernel against its plain PyTorch version on the card, on
     the inputs of the first bounces of an 800x600 programmer-art render
     (480,000 camera rays, then scattered and NEE rays), and time both;
  3. render 64x48 2spp and 160x120 8spp with reference_config() and hold
     them against the goldens in assets/ (PSNR > 40 dB, SMAPE < 0.02, the
     cross-platform gate); hold the 64x48 GPU render against the port's
     CPU render of the same frame (PSNR > 40 dB);
  4. render the bench workload (800x600, 6 bounces / 4 diffuse, NEE 1+1,
     8 spp as one regenerating wavefront) with every launch counter set to
     0 just before, and require each kernel to have launched;
  5. print a JSON line describing the kernels, then the result line.

Needs CUDA: exits non-zero without printing a result when
torch.cuda.is_available() is false.
"""
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
}
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


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls (CUDA events, after
    one warm-up call)."""
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
    """Records the arguments of the first calls of the kernel wrappers
    during one render (the inputs the main path gives each kernel): the
    first three traces (camera rays, their NEE rays, the scattered rays),
    the gathers and the shade pass of the first bounce."""
    LIMIT = {"trace_dense": 3, "gather_rows": 16, "gather_rows_interp": 1,
             "shade_nee": 1}

    def __init__(self):
        from rtxpt_tpu_torch.ops import gather, mt_dense
        from rtxpt_tpu_torch.pt import shade_kernel
        self.targets = [(mt_dense, "trace_dense"), (gather, "gather_rows"),
                        (gather, "gather_rows_interp"),
                        (shade_kernel, "shade_nee")]
        self.calls = {name: [] for _, name in self.targets}
        self.orig = {}

    def __enter__(self):
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.orig[name] = (mod, fn)

            def wrapped(*args, _fn=fn, _name=name, **kw):
                if len(self.calls[_name]) < self.LIMIT[_name]:
                    self.calls[_name].append(
                        ([a.clone() if torch.is_tensor(a) else a
                          for a in args], dict(kw)))
                return _fn(*args, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, (mod, fn) in self.orig.items():
            setattr(mod, name, fn)


def check_kernels(results: dict):
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.ops import gather, mt_dense
    from rtxpt_tpu_torch.scene import envmap as EM, procedural

    w, h = 800, 600
    host = procedural.build_programmer_art().finish()
    cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                           nee_distant_samples=1, nee_local_samples=1)
    r = Renderer(host, procedural.default_camera(w, h), cfg,
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    with Capture() as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()

    # ---- K1: the first closest trace (camera rays), the second (one
    # bounce of scattered rays) and the first any-hit trace (NEE rays)
    closest = [c for c in cap.calls["trace_dense"] if not c[1]["any_hit"]]
    anyhit = [c for c in cap.calls["trace_dense"] if c[1]["any_hit"]]
    require(len(closest) >= 2 and anyhit, "K1: too few traces captured")
    k1_ms = k1_plain_ms = 0.0
    k1_err = 0.0
    for label, (args, kw) in (("camera", closest[0]),
                              ("scattered", closest[1]),
                              ("nee any-hit", anyhit[0])):
        aabb_c, tri9, o_c, d, tmax, act = args
        t_k, s_k = mt_dense.trace_dense(*args, **kw)
        t_p, s_p = mt_dense.trace_dense_plain(*args, **kw)
        torch.cuda.synchronize()
        lanes = int(act.sum())
        if kw["any_hit"]:
            agree = float(((s_k >= 0) == (s_p >= 0))[act].float().mean())
            print(f"K1 {label}: {act.numel()} lanes ({lanes} active), "
                  f"occlusion flag equal on {agree:.6%}")
            require(agree >= 0.9999, f"K1 any-hit agreement {agree}")
        else:
            same = (s_k == s_p) & act
            agree = float(same[act].float().mean())
            hk = mt_dense.resolve_hits(r.dense, o_c, d, t_k, s_k)
            hp = mt_dense.resolve_hits(r.dense, o_c, d, t_p, s_p)
            m = same & (s_k >= 0)
            err = max(float((hk.t - hp.t)[m].abs().max()),
                      float((hk.bary - hp.bary)[m].abs().max()))
            k1_err = max(k1_err, err)
            ok_tuv = torch.allclose(hk.t[m], hp.t[m], rtol=1e-5, atol=1e-6) \
                and torch.allclose(hk.bary[m], hp.bary[m], rtol=1e-5,
                                   atol=1e-6)
            print(f"K1 {label}: {act.numel()} lanes ({lanes} active), same "
                  f"winner on {agree:.6%}, t/u/v max |diff| {err:.3g}")
            require(agree >= 0.9999, f"K1 winner agreement {agree}")
            require(ok_tuv, "K1 t/u/v outside rtol 1e-5 / atol 1e-6")
        if label != "scattered":
            ms = time_ms(lambda: mt_dense.trace_dense(*args, **kw), 20)
            pms = time_ms(lambda: mt_dense.trace_dense_plain(*args, **kw), 2)
            print(f"K1 {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
            k1_ms += ms
            k1_plain_ms += pms
    results["mt_dense"] = dict(max_abs_err=k1_err, ms=k1_ms,
                               plain_ms=k1_plain_ms)

    # ---- K2: each distinct row gather of the first (full-width) bounce,
    # bit-equal
    k2_ms = k2_plain_ms = 0.0
    seen = set()
    for args, kw in cap.calls["gather_rows"]:
        table, idx = args
        key = (tuple(table.shape), table.dtype)
        if idx.numel() != w * h or key in seen:
            continue
        seen.add(key)
        got = gather.gather_rows(table, idx)
        ref = gather.gather_rows_plain(table, idx)
        require(torch.equal(got, ref),
                f"K2 gather of a {tuple(table.shape)} table not bit-equal")
        ms = time_ms(lambda: gather.gather_rows(table, idx), 50)
        pms = time_ms(lambda: gather.gather_rows_plain(table, idx), 50)
        print(f"K2 {tuple(table.shape)} {table.dtype} x {idx.numel()} rows:"
              f" bit-equal, kernel {ms:.4f} ms, plain {pms:.4f} ms")
        k2_ms += ms
        k2_plain_ms += pms
    require(len(seen) >= 5, "K2: too few gathers captured")
    results["gather_rows"] = dict(max_abs_err=0.0, ms=k2_ms,
                                  plain_ms=k2_plain_ms)

    # ---- K3: the barycentric vertex blend of the first bounce
    args, kw = cap.calls["gather_rows_interp"][0]
    got = gather.gather_rows_interp(*args)
    ref = gather.gather_rows_interp_plain(*args)
    err = float((got - ref).abs().max())
    require(torch.allclose(got, ref, rtol=1e-6, atol=1e-6),
            f"K3 outside rtol 1e-6 / atol 1e-6 (max |diff| {err})")
    ms = time_ms(lambda: gather.gather_rows_interp(*args), 50)
    pms = time_ms(lambda: gather.gather_rows_interp_plain(*args), 50)
    print(f"K3 {args[1].shape[0]} lanes: max |diff| {err:.3g}, kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms")
    results["gather_rows_interp"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=pms)

    # ---- K4: the shade pass of the first bounce, at the bench's NEE 1+1
    # and at the goldens' NEE 2+2 (reference_config())
    err, ms, pms = check_shade(*cap.calls["shade_nee"][0])
    results["shade_nee"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    r = Renderer(host, procedural.default_camera(w, h), reference_config(),
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    with Capture() as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    check_shade(*cap.calls["shade_nee"][0])


def check_shade(args, kw):
    """K4 against its plain version: lobe and flags equal on >= 99.99% of
    lanes, the rest within rtol 2e-4 / atol 2e-5 on those lanes."""
    from rtxpt_tpu_torch.pt import shade_kernel as SK
    got = SK.shade_nee(*args, **kw)
    ref = SK.shade_nee_plain(*args, **kw)
    L = SK.out_layout(kw["nee_distant"], kw["nee_local"])
    flags = ["lobe", "scatter_valid", "will_scatter", "rr_kill",
             "non_delta_scatter"] + [f"nee_need{i}" for i in range(
                 kw["nee_distant"] + kw["nee_local"])]
    rows = [L.map[f][0] for f in flags]
    same = (got[rows] == ref[rows]).all(0)
    agree = float(same.float().mean())
    err = float((got[:, same] - ref[:, same]).abs().max())
    close = torch.allclose(got[:, same], ref[:, same], rtol=2e-4, atol=2e-5)
    print(f"K4 NEE {kw['nee_distant']}+{kw['nee_local']}, "
          f"{got.shape[1]} lanes: lobe/flags equal on {agree:.6%}, max "
          f"|diff| {err:.3g}")
    require(agree >= 0.9999, f"K4 lobe/flag agreement {agree}")
    require(close, "K4 outside rtol 2e-4 / atol 2e-5")
    ms = time_ms(lambda: SK.shade_nee(*args, **kw), 20)
    pms = time_ms(lambda: SK.shade_nee_plain(*args, **kw), 5)
    print(f"K4 NEE {kw['nee_distant']}+{kw['nee_local']}: kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms")
    return err, ms, pms


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


def bench(results: dict, card: str):
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
    for name, (counter, _, _) in KERNELS.items():
        require(counts[counter] > 0,
                f"{name} was not launched on the main path")
        results[name]["launches"] = counts[counter]
    return wall, mpaths


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
    t0 = time.time()
    cuda_lib.lib()
    print(f"built CUDA kernels in {time.time() - t0:.1f} s "
          f"({cuda_lib.build()})", flush=True)

    results = {}
    check_kernels(results)
    check_goldens()
    bench(results, card)
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=results[name]["launches"],
                    max_abs_err=results[name]["max_abs_err"],
                    ms=results[name]["ms"],
                    plain_ms=results[name]["plain_ms"])
               for name, (_, src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
