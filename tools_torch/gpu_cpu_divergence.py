"""Where the port's render on a CUDA GPU parts from its render on the CPU
(the plain versions of its kernels): a development tool, outside the
package; from the repo root:

    python -m tools_torch.gpu_cpu_divergence [--width 64 --height 48 --spp 2]

Renders chip_smoke.py's foliage dense scene (programmer-art and 1,500
alpha-MASK leaf cards, reference mode, the bench config) in variants that
switch off one thing at a time: the exact alpha test (the masks alone),
the normal map, and the alpha test altogether (the cards opaque); and
programmer-art alone. Each variant is rendered on both devices with every
trace call recorded in order (traverse.trace_closest and trace_anyhit:
rays, active lanes, hits) and every alpha test of the exact visibility
re-queue (visibility.sample_opacity). Prints per variant: the HDR and the
tonemapped PSNR, the pixels whose tonemapped value differs by more than
1e-3 and the PSNR over the others; the first trace call whose active lanes
or hits differ between the devices, with the largest ray difference of the
calls before it and of that call; and the alpha tests that decide
differently on lanes that hit the same triangle.

Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess

import numpy as np
import torch

DIFF = 1e-3       # a pixel "differs" above this tonemapped difference


class Recorder:
    """Records, in call order, every trace call and every alpha test of
    one render while active (host copies)."""

    def __enter__(self):
        from rtxpt_tpu_torch.ops import traverse
        from rtxpt_tpu_torch.pt import visibility
        self.calls, self.alpha, self.orig = [], [], []

        def wrap(mod, name, record):
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))

            def wrapped(*args, **kw):
                out = fn(*args, **kw)
                record(args, kw, out)
                return out
            setattr(mod, name, wrapped)

        def trace(kind):
            def record(args, kw, out):
                o, d = args[1], args[2]
                act = kw.get("active")
                if act is None:
                    act = torch.ones(o.shape[0], dtype=torch.bool,
                                     device=o.device)
                res = out.prim if kind == "closest" else out.to(torch.int32)
                self.calls.append((kind, o.cpu(), d.cpu(), act.cpu(),
                                   res.cpu()))
            return record

        def alpha(args, kw, out):
            mode, cutoff, opacity = out
            self.alpha.append((args[1].cpu(),
                               ((mode == 1) & (opacity < cutoff)).cpu(),
                               opacity.cpu()))
        wrap(traverse, "trace_closest", trace("closest"))
        wrap(traverse, "trace_anyhit", trace("anyhit"))
        wrap(visibility, "sample_opacity", alpha)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.orig):
            setattr(mod, name, fn)


def render(host, cfg, w, h, spp, device):
    from rtxpt_tpu_torch.models.renderer import Renderer
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    r = Renderer(host, procedural.default_camera(w, h), cfg,
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device=device)
    with Recorder() as rec:
        hdr = r.render(w, h, spp)
    tm = r.tonemapped(hdr)
    return hdr.cpu().numpy(), tm.cpu().numpy(), rec


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    peak = max(float(a.max()), float(b.max()), 1e-9)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def first_divergence(g: Recorder, c: Recorder) -> str:
    """The first trace call whose active lanes or hits differ."""
    drift = 0.0
    for i, (cg, cc) in enumerate(zip(g.calls, c.calls)):
        kind, og, dg, ag, rg = cg
        _, oc, dc, ac, rc = cc
        if og.shape != oc.shape:
            return (f"trace call {i} ({kind}) has {og.shape[0]} lanes on "
                    f"the GPU, {oc.shape[0]} on the CPU; largest ray "
                    f"difference of the calls before it {drift:.3e}")
        both = ag & ac
        ray = float(torch.maximum((og - oc).abs().amax(1),
                                  (dg - dc).abs().amax(1))[both].max()) \
            if bool(both.any()) else 0.0
        n_act = int((ag != ac).sum())
        n_hit = int(((rg != rc) & both).sum())
        if n_act or n_hit:
            lanes = torch.nonzero((rg != rc) & both)[:, 0]
            lane_ray = float(torch.maximum(
                (og - oc).abs().amax(1), (dg - dc).abs().amax(1))[
                    lanes].max()) if lanes.numel() else 0.0
            return (f"first differing trace call {i} of {len(g.calls)} "
                    f"(GPU) / {len(c.calls)} (CPU), {kind}, "
                    f"{og.shape[0]} lanes: {n_act} lanes differ in being "
                    f"active, {n_hit} active lanes hit differently (their "
                    f"rays differ by at most {lane_ray:.3e}); largest ray "
                    f"difference of the calls before it {drift:.3e}, of "
                    f"this call {ray:.3e}")
        drift = max(drift, ray)
    return (f"no trace call differs in its active lanes or hits "
            f"({len(g.calls)} / {len(c.calls)} calls; largest ray "
            f"difference {drift:.3e})")


def alpha_flips(g: Recorder, c: Recorder) -> str:
    """Alpha tests that decide differently on the same triangle."""
    tests = flips = 0
    gap = []
    for (pg, tg, og), (pc, tc, oc) in zip(g.alpha, c.alpha):
        if pg.shape != pc.shape:
            break
        same = pg == pc
        tests += int(same.sum())
        f = same & (tg != tc)
        flips += int(f.sum())
        if bool(f.any()):
            gap.append(float((og - oc)[f].abs().max()))
    return (f"{tests} alpha tests on the same triangle on both devices, "
            f"{flips} decide differently"
            + (f" (opacity differs by at most {max(gap):.3e} there)"
               if gap else ""))


def variant_host(name, foliage, plain):
    import copy
    if name == "programmer-art alone":
        return plain
    host = copy.deepcopy(foliage)
    mats = host["materials"]
    leaf = mats["alpha_mode"] == 1
    if name == "no normal map":
        mats["normal_tex"][leaf] = -1
    elif name == "cards opaque":
        mats["alpha_mode"][leaf] = 0
    return host


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--height", type=int, default=48)
    p.add_argument("--spp", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gpu_cpu_divergence needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from chip_smoke import BENCH_CFG, foliage_host
    from rtxpt_tpu_torch.models.renderer import reference_config
    from rtxpt_tpu_torch.scene import procedural
    cfg = reference_config(**BENCH_CFG)
    foliage = foliage_host("programmer-art")
    plain = procedural.build_programmer_art().finish()
    w, h, spp = args.width, args.height, args.spp
    for name, exact in (("foliage dense", True), ("masks alone", False),
                        ("no normal map", True), ("cards opaque", True),
                        ("programmer-art alone", True)):
        host = variant_host(name, foliage, plain)
        c = dataclasses.replace(cfg, exact_alpha_test=exact)
        hg, tg, rg = render(host, c, w, h, spp, "cuda")
        hc, tc, rc = render(host, c, w, h, spp, "cpu")
        d = np.abs(tg.astype(np.float64) - tc).max(-1)
        keep = d <= DIFF
        rest = psnr(tg[keep], tc[keep]) if keep.any() else float("nan")
        print(f"{name} {w}x{h} {spp}spp (exact alpha test {exact}): HDR "
              f"PSNR {psnr(hg, hc):.2f} dB, HDR values bit-equal "
              f"{int((hg == hc).sum())} of {hg.size}; tonemapped PSNR "
              f"{psnr(tg, tc):.2f} dB; {int((~keep).sum())} of {d.size} "
              f"pixels differ by more than {DIFF} (at most {d.max():.4f}), "
              f"PSNR {rest:.2f} dB over the others", flush=True)
        print(f"  {first_divergence(rg, rc)}", flush=True)
        print(f"  {alpha_flips(rg, rc)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
