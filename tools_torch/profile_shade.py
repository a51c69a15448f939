"""Shade-kernel lab: K4 and K4 FILL (``csrc/shade_kernel.cu``) on the
first-bounce inputs of the four main paths and of the bench at NEE 2+2,
against another checkout's shade kernel (built into a library of its own)
on the same inputs, in one process on one card.

    python -m tools_torch.profile_shade --parent DIR

DIR is the root of the other checkout (its ``rtxpt_tpu_torch/csrc`` must
hold a shade_kernel.cu with this tree's C entry points
``rtxpt_shade_nee`` and ``rtxpt_shade_nee_fill``): the parent commit, or
a copy of this tree with the kernel changed, to measure a variant.
Without --parent only this tree's kernel is timed.

Cases: bench (programmer-art 800x600, bench config: NEE 1+1), bench NEE
2+2 (the same frame under reference_config(), the goldens' config), city
(1920x1080, bench config), realtime city (1920x1080) and realtime 360p
(programmer-art 640x360; both K4 FILL at NEE 2+2 on the first FILL bounce
of a default realtime frame). On each: this tree's kernel and the other
checkout's, every output row of the other's bit-equal to this tree's
(torch.equal); for each, its registers, shared bytes and spills (ptxas's
report on its source), its SASS operations and instructions a lane and
the time in which the card can dispatch those instructions (chip_smoke.py
`shade_instances`, `dispatch_ms`); the bound (chip_smoke.py: bytes, or the
SASS operation count); and the device time of what surrounds the kernel
on the path: `pack_inputs` on the named inputs the integrator gave it,
and the copies its consumers make of the unpacked (strided) output rows.
Times are device times (chip_smoke.py `device_ms`: a CUDA graph of the
launches replayed) with the CUDA-event times of launches from the host in
brackets. Needs a CUDA GPU and the CUDA toolkit's cuobjdump.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
from pathlib import Path

import torch

import chip_smoke as CS
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.pt import shade_kernel as SK

ENTRIES = ("rtxpt_shade_nee", "rtxpt_shade_nee_fill")
CASES = ("bench", "bench_nee22", "city", "realtime_city", "realtime_360p")


def this_tree() -> dict:
    """This tree's K4 instantiations (the renderer's library)."""
    return CS.shade_instances(cuda_lib.ptxas_report("shade_kernel.cu"),
                              cuda_lib.build())


class Other:
    """The other checkout's shade_kernel.cu, built alone into a library of
    its own, and its instantiations' figures."""

    def __init__(self, root: Path):
        self.csrc = root / "rtxpt_tpu_torch" / "csrc"

    def build(self):
        sigs = {e: cuda_lib.SIGNATURES[e] for e in ENTRIES}
        self.lib = cuda_lib.load("rtxpt_shade_other", ("shade_kernel.cu",),
                                 sigs, csrc=self.csrc)
        # a kernel with dynamic shared memory stages its input rows as
        # this tree's does; one without reads them from global memory
        source = (self.csrc / "shade_kernel.cu").read_text()
        self.inst = CS.shade_instances(
            cuda_lib.ptxas_report("shade_kernel.cu", csrc=self.csrc),
            cuda_lib.build(stem="rtxpt_shade_other",
                           sources=("shade_kernel.cu",), csrc=self.csrc),
            staged="extern __shared__" in source)
        return self

    def run(self, args, kw, fill):
        planes, consts4 = args
        n = planes.shape[1]
        rows = SK.out_layout(kw["nee_distant"], kw["nee_local"], fill).rows
        out = torch.empty((rows, n), dtype=torch.float32,
                          device=planes.device)
        cuda_lib.launch(ENTRIES[fill], planes.data_ptr(), consts4.data_ptr(),
                        out.data_ptr(), n, kw["nee_distant"], kw["nee_local"],
                        int(kw["rr"]), int(kw["max_bounces"]),
                        int(kw["max_diffuse_bounces"]),
                        float(kw["spec_rough_threshold"]),
                        float(kw["local_pdf_k"]), library=self.lib)
        return out


class PackCapture:
    """Records the first `pack_inputs` call of the integrator while
    active: (layout, lanes, named inputs)."""

    def __enter__(self):
        self.orig, self.call = SK.pack_inputs, None

        def pack(L, n, values):
            if self.call is None:
                self.call = (L, n, dict(values))
            return self.orig(L, n, values)
        SK.pack_inputs = pack
        return self

    def __exit__(self, *exc):
        SK.pack_inputs = self.orig


_CITY = []


def _city():
    if not _CITY:
        _CITY.append(CS.build_city())
    return _CITY[0]


def capture(case: str):
    """(K4 args, kw, fill, the pack_inputs call) of one case's first
    shade launch."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    city = case in ("city", "realtime_city")
    host = _city() if city else procedural.build_programmer_art().finish()
    if case.startswith("realtime"):
        w, h = (1920, 1080) if city else (640, 360)
        cam = procedural.city_camera(w, h) if city \
            else procedural.default_camera(w, h)
        r = RealtimeRenderer(host, cam, device="cuda")
        with CS.Capture(dict(shade_nee_fill=1), during=("fill",)) as cap, \
                PackCapture() as pc:
            r.render_frame(w, h)
            torch.cuda.synchronize()
        args, kw = cap.calls["shade_nee_fill"][0]
        return args, kw, True, pc.call
    w, h = (1920, 1080) if city else (800, 600)
    cam = procedural.city_camera(w, h) if city \
        else procedural.default_camera(w, h)
    cfg = reference_config() if case == "bench_nee22" else reference_config(
        max_bounces=6, max_diffuse_bounces=4, nee_distant_samples=1,
        nee_local_samples=1)
    r = Renderer(host, cam, cfg,
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    with CS.Capture(dict(shade_nee=1)) as cap, PackCapture() as pc:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    args, kw = cap.calls["shade_nee"][0]
    return args, kw, False, pc.call


def both(fn) -> tuple:
    """(device ms, CUDA-event ms) of fn()."""
    return CS.device_ms(fn), CS.time_ms(fn, 20)


def fmt(t) -> str:
    return f"{t[0]:.4f} ({t[1]:.4f})"


def run_case(case: str, this: dict, other) -> dict:
    args, kw, fill, (L, n, values) = capture(case)
    planes = args[0]
    key = (kw["nee_distant"], kw["nee_local"], bool(kw["rr"]), fill)
    Lout = SK.out_layout(key[0], key[1], fill)
    kernel = SK.shade_nee_fill if fill else SK.shade_nee
    got = kernel(*args, **kw)
    b_ms, b_by = CS.bound((planes.shape[0] + Lout.rows) * n * 4,
                          n * this[key]["ops"])
    out = {"case": case, "lanes": n, "instance": list(key),
           "rows": [planes.shape[0], Lout.rows], "bound_ms": b_ms,
           "bound_by": b_by, "kernels": {}}
    runs = {"this tree": (this, lambda: kernel(*args, **kw))}
    if other:
        res = other.run(args, kw, fill)
        differ = [r for r in range(Lout.rows)
                  if not torch.equal(res[r], got[r])]
        CS.require(not differ, f"{case}: the other checkout's K4 differs "
                   f"on output rows {differ}")
        runs["other checkout"] = (other.inst,
                                  lambda: other.run(args, kw, fill))
    for label, (inst, fn) in runs.items():
        out["kernels"][label] = dict(
            time=both(fn), dispatch_ms=CS.dispatch_ms(n, inst[key][
                "instructions"]), **inst[key])
    out["pack_inputs"] = both(lambda: SK.pack_inputs(L, n, values))
    unpacked = SK.unpack_out(Lout, got)
    out["consumer_copies"] = both(
        lambda: [v.contiguous() for v in unpacked.values()])
    print(f"{case}: K4{' FILL' if fill else ''} NEE {key[0]}+{key[1]}, "
          f"{n} lanes, {planes.shape[0]} + {Lout.rows} rows; bound "
          f"{b_ms:.4f} ms ({b_by})"
          + ("; every output row bit-equal to the other checkout's"
             if other else ""), flush=True)
    for label, k in out["kernels"].items():
        print(f"  {label}: {fmt(k['time'])} ms; {k['registers']} registers,"
              f" {k['shared']} B shared, {k['spill']} B spilled, "
              f"{k['ops']} SASS operations and {k['instructions']} "
              f"instructions a lane (dispatch {k['dispatch_ms']:.4f} ms)",
              flush=True)
    print(f"  pack_inputs {fmt(out['pack_inputs'])} ms; consumers' copies "
          f"of the unpacked rows {fmt(out['consumer_copies'])} ms",
          flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("rtxpt_tpu_torch shade-kernel lab")
    p.add_argument("--parent", type=Path, default=None,
                   help="root of another checkout whose K4 to time")
    p.add_argument("--cases", default=",".join(CASES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_shade: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(CS.card_line(), flush=True)
    other = Other(args.parent.resolve()) if args.parent else None
    # both libraries and their ptxas reports built at once
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(this_tree)] + (
            [pool.submit(other.build)] if other else [])
        this = jobs[0].result()
        for job in jobs[1:]:
            job.result()
    results = [run_case(case, this, other)
               for case in args.cases.split(",")]
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
