"""ReLAX's and TAA's kernels (``csrc/relax.cu``) at the realtime cell's
shape: each kernel's time by CUDA events over --launches launches, its
launches in a frame of the stable-planes pipeline (3 planes, a diffuse
channel of 4 a-trous iterations and a specular one of 3 per plane, one TAA
resolve), its byte bound at 3.35 TB/s, and its plain version's time on the
same inputs. Every output is first compared with the plain version's
(max |diff|, 0 where bit-equal).

    python -m tools_torch.profile_relax [--width 1920 --height 1080]
        [--launches 30] [--out FILE]

Inputs are made from a seed: noisy radiance, normals with a crease, a depth
step, sub-pixel motion, roughness. The denoiser's history is accumulated
over --frames frames of them, so the variance pass meets pixels both
younger and older than its 4-frame switch (the share of young pixels is
printed). Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke as CS
from rtxpt_tpu_torch.denoise import relax
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.post import taa

# launches a frame of the cell's pipeline: 3 planes x 2 channels, the
# diffuse channel's steps 1, 2, 4, 8 and the specular channel's 1, 2, 4
PLANES = 3
DIFFUSE_ITERS, SPECULAR_ITERS = 4, 3


def frame_inputs(seed: int, h: int, w: int, dev):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rad = rs.gamma(1.0, 1.0, (h, w, 3)) * (1.0 + (xx > w / 2))[..., None]
    nrm = np.stack([np.where(xx > w / 3, 0.6, 0.0), 0.1 * np.sin(yy / 8),
                    np.ones_like(xx)], -1)
    nrm = nrm + 0.02 * rs.normal(size=nrm.shape)
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    z = 4.0 + 0.005 * yy + np.where(yy > h / 2, 3.0, 0.0)
    motion = rs.uniform(-1.5, 1.5, (h, w, 2))
    rough = rs.uniform(0.0, 1.0, (h, w))
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    return t(rad), t(nrm), t(z), t(motion), t(rough)


def max_diff(a, b) -> float:
    """max |a - b| (0.0 where bit-equal)."""
    return 0.0 if torch.equal(a, b) else (a - b).abs().max().item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--launches", type=int, default=30)
    ap.add_argument("--plain-calls", type=int, default=3)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="write every row as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda")
    h, w, n = args.height, args.width, args.launches
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; {w}x{h}", flush=True)

    rad, nrm, z, motion, rough = frame_inputs(0, h, w, dev)
    state = relax.DenoiserState.create(h, w, dev)
    for f in range(args.frames):
        state = relax.temporal_accumulate(state,
                                          *frame_inputs(f, h, w, dev)[:4])
    young = float((state.history < 4.0).float().mean())
    print(f"history after {args.frames} frames: young share {young:.4f}",
          flush=True)
    var = relax.estimate_variance(state)
    px = h * w
    rows = []

    def row(name, kernel, plain, nbytes, per_frame, diff, plain_share=1.0):
        """Times kernel() and plain() (plain_share: the share of a plain
        call that one kernel launch replaces); diff: the max |diff| of
        their outputs, found beforehand."""
        ms = CS.time_ms(kernel, n)
        plain_ms = CS.time_ms(plain, args.plain_calls) * plain_share
        bound_ms = nbytes * px / CS.HBM_BYTES_PER_S * 1e3
        rows.append(dict(kernel=name, ms=ms, launches_per_frame=per_frame,
                         bound_ms=bound_ms, bytes_per_pixel=nbytes,
                         plain_ms=plain_ms, x_bound=ms / bound_ms,
                         frame_ms=ms * per_frame, max_abs_diff=diff))
        print(f"{name:28s} {ms:8.4f} ms  x{per_frame:<2d} a frame  bound "
              f"{bound_ms:7.4f} ms ({nbytes} B/px, {ms / bound_ms:5.2f}x)  "
              f"plain {plain_ms:9.3f} ms  max |diff| {diff:.3g}", flush=True)

    # temporal: the history's 40 B and the frame's 36 B read, 24 B written
    frame = (rad, nrm, z, motion)
    kernel = lambda: relax.temporal_accumulate(state, *frame)
    plain = lambda: relax.temporal_accumulate_plain(state, *frame)
    row("relax_temporal", kernel, plain, 100, 2 * PLANES,
        max(max_diff(a, b) for a, b in zip(kernel(), plain())))
    # variance: radiance, moments, history read, the variance written
    kernel = lambda: relax.estimate_variance(state)
    plain = lambda: relax.estimate_variance_plain(state)
    row("relax_variance", kernel, plain, 28, 2 * PLANES,
        max_diff(kernel(), plain()))
    # a-trous: radiance, variance, normal, depth (roughness) read once,
    # radiance and variance written. A row a step: the kernel launched at
    # that step alone; the plain time is a whole channel's call over its
    # iterations, shared out evenly
    ops = [cuda_lib.kernel_operand(t, "x", t.shape)
           for t in (state.radiance, var, nrm, z, rough)]
    o_rad, o_var = torch.empty_like(ops[0]), torch.empty_like(ops[1])
    for spec, iters in ((False, DIFFUSE_ITERS), (True, SPECULAR_ITERS)):
        r = rough if spec else None
        plain = lambda r=r, iters=iters: relax.atrous_filter_plain(
            state.radiance, var, nrm, z, r, iters)
        diff = max_diff(
            relax.atrous_filter(state.radiance, var, nrm, z, r, iters),
            plain())
        for it in range(iters):
            def one(step=1 << it, spec=spec):
                cuda_lib.launch(
                    "rtxpt_relax_atrous", *(t.data_ptr() for t in ops[:4]),
                    ops[4].data_ptr() if spec else None, o_rad.data_ptr(),
                    o_var.data_ptr(), h, w, step, 4.0, 64.0, 1.0)
            row(f"relax_atrous {'spec' if spec else 'diff'} step {1 << it}",
                one, plain, 52 if spec else 48, PLANES, diff, 1.0 / iters)
    taa_state = taa.TAAState(history=frame_inputs(9, h, w, dev)[0],
                             valid=True)
    mask = torch.clamp(2.0 - state.history, 0.0, 1.0)
    # TAA: history, colour, motion, mask read, the colour written
    kernel = lambda: taa.resolve(taa_state, rad, motion, relax_mask=mask)[0]
    plain = lambda: taa.resolve_plain(taa_state, rad, motion,
                                      relax_mask=mask)[0]
    row("taa_resolve", kernel, plain, 48, 1, max_diff(kernel(), plain()))

    frame_ms = sum(r["frame_ms"] for r in rows)
    bound_frame = sum(r["bound_ms"] * r["launches_per_frame"] for r in rows)
    plain_frame = sum(r["plain_ms"] * r["launches_per_frame"] for r in rows)
    launches = sum(r["launches_per_frame"] for r in rows)
    print(f"a frame: {launches} launches, {frame_ms:.4f} ms (bound "
          f"{bound_frame:.4f}, plain {plain_frame:.3f})", flush=True)
    out = dict(card=card.strip(), width=w, height=h, launches=n,
               young_share=young, rows=rows, frame_ms=frame_ms,
               frame_bound_ms=bound_frame, frame_plain_ms=plain_frame,
               frame_launches=launches)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}))


if __name__ == "__main__":
    main()
