"""Traversal-ingredient lab: the port's counterpart of tools/kernel_lab.py
(K8). Times the micro-kernels of rtxpt_tpu_torch/csrc/kernel_lab.cu, one
per ingredient of the BVH8 traversal K5 (a carry add, a node-row fetch, a
local-memory stack, a leaf Möller–Trumbore, 8 slabs and the sorting
network, a warp vote, a shared-memory stack), and prints microseconds per
iteration of all LANES lanes. Each kernel is first held against its plain
PyTorch version (the same arithmetic, rtol 1e-6) at a few iterations.

    python -m tools_torch.kernel_lab [--iters N]

Needs a CUDA GPU; builds its library into rtxpt_tpu_torch/_build/ at
first use (nvcc).
"""
from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from rtxpt_tpu_torch.ops import cuda_lib

LANES = 132 * 1024          # 1,024 lanes per SM of the H100
ROWS, WIDTH, STACK = 640, 144, 48
ITERS = 2000                # timed iterations
CHECK_ITERS = 16            # iterations of the plain-version check
KERNELS = ("empty", "row_fetch", "local_stack", "leaf_mt", "slab_sort",
           "warp_vote", "shared_stack")     # csrc/kernel_lab.cu enum Which
# operations per lane and iteration, counted from csrc/kernel_lab.cu
# (integer, compare and select operations counted like float ones)
OPS = {"empty": 1, "row_fetch": 148, "local_stack": 45, "leaf_mt": 16 * 52,
       "slab_sort": 8 * 31 + 19 * 5 + 8, "warp_vote": 4, "shared_stack": 20}
SOURCE = "rtxpt_tpu_torch/csrc/kernel_lab.cu"
REPLACES = {name: "tools/kernel_lab.py:52" for name in KERNELS}
REPLACES["shared_stack"] = "tools/kernel_lab.py:247"

_lib = None


def library() -> ctypes.CDLL:
    """The lab's kernel library (built on first use, apart from the
    renderer's)."""
    global _lib
    if _lib is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _lib = cuda_lib.load("rtxpt_lab", ("kernel_lab.cu",),
                             {"rtxpt_lab_run": (I, P, P, I, I, P)})
    return _lib


def make_table(device) -> torch.Tensor:
    """The (ROWS, WIDTH) f32 row table of row_fetch, from a seed."""
    r = np.random.RandomState(0)
    return torch.as_tensor(r.uniform(0.0, 1.0, (ROWS, WIDTH))
                           .astype(np.float32), device=device)


@cuda_lib.counted("kernel_lab")
def run(name: str, table: torch.Tensor, iters: int,
        lanes: int = LANES) -> torch.Tensor:
    """Micro-kernel `name` over `lanes` lanes (a multiple of 128) for
    `iters` iterations -> each lane's carry (lanes,) f32."""
    if table.device.type != "cuda":
        raise ValueError("the kernel lab runs on a CUDA device")
    cuda_lib.check(table, "table", torch.float32, (ROWS, WIDTH))
    out = torch.empty((lanes,), dtype=torch.float32, device=table.device)
    cuda_lib.bump("kernel_lab")
    cuda_lib.launch("rtxpt_lab_run", KERNELS.index(name), table.data_ptr(),
                    out.data_ptr(), lanes, iters, library=library())
    return out


def _carry0(lane):
    return 1.0 + 0.125 * (lane & 7).to(torch.float32)


def plain(name: str, table: torch.Tensor, iters: int,
          lanes: int = LANES) -> torch.Tensor:
    """The plain version of micro-kernel `name`: the same float32
    operations, vectorized over the lanes."""
    dev = table.device
    lane = torch.arange(lanes, device=dev)
    f = lambda v: torch.full((lanes,), v, dtype=torch.float32, device=dev)
    c = _carry0(lane)
    if name == "empty":
        for _ in range(iters):
            c = c + 1.0
        return c
    if name == "row_fetch":
        row_max = table.amax(1)
        for it in range(iters):
            bits = c.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            c = c + row_max[(bits + it) % ROWS] * 0.0009765625
        return c
    if name == "local_stack":
        stack = torch.arange(STACK, device=dev)[None, :] + (lane & 15)[:, None]
        sp = 8 + (lane & 7)
        acc = torch.zeros_like(lane)
        for it in range(iters):
            top = stack.gather(1, (sp - 1)[:, None])[:, 0]
            sp = sp - 1
            for k in range(8):
                push = ((top + it + k) & 3) != 0
                stack[lane[push], sp[push]] = top[push] + k + 1
                sp = sp + push.to(sp.dtype)
            sp = torch.where(sp > 40, sp - 32, sp)
            sp = torch.clamp(sp, min=1)
            acc = acc + top
        return ((acc & 0xFFFFF)).to(torch.float32)
    if name == "leaf_mt":
        dx, dy, dz = 0.125, -0.25, -1.0
        for _ in range(iters):
            ox, oy, oz = c, c * 0.5, f(0.25)
            acc = f(0.0)
            for k in range(16):
                kf = float(k)
                p0x = f(kf * 0.125) - c * 0.25
                p0y = c * 0.5 - f(kf * 0.0625)
                p0z = f(-2.0) - f(kf * 0.25)
                e1x, e1y, e1z = f(1.0) + f(kf * 0.03125), f(0.5), f(kf * 0.0625)
                e2x, e2y, e2z = f(-0.5), 1.0 + c * 0.125, f(0.25)
                hx = dy * e2z - dz * e2y
                hy = dz * e2x - dx * e2z
                hz = dx * e2y - dy * e2x
                a = e1x * hx + e1y * hy + e1z * hz
                fa = 1.0 / torch.where(torch.abs(a) < 1e-12, 1e-12, a)
                sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
                u = fa * (sx * hx + sy * hy + sz * hz)
                qx = sy * e1z - sz * e1y
                qy = sz * e1x - sx * e1z
                qz = sx * e1y - sy * e1x
                v = fa * (dx * qx + dy * qy + dz * qz)
                t = fa * (e2x * qx + e2y * qy + e2z * qz)
                hit = ((torch.abs(a) > 1e-12) & (u >= 0.0) & (v >= 0.0)
                       & (u + v <= 1.0) & (t > 0.0) & (t < 1e30))
                acc = acc + torch.where(hit, t, 0.0)
            c = c * 0.5 + 1.0 + acc * 0.0078125
        return c
    if name == "slab_sort":
        sort8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6),
                 (5, 7), (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6),
                 (1, 4), (3, 6), (2, 4), (3, 5), (3, 4))
        for _ in range(iters):
            ox, oy, oz = c, c * 0.5, 0.25
            ix, iy, iz = 1.0 + c * 0.25, -0.5, 2.0
            ts, cs = [], []
            for k in range(8):
                b = [c * (0.015625 * (k * 6 + j)) for j in range(6)]
                t0x, t1x = (b[0] - ox) * ix, (b[3] - ox) * ix
                t0y, t1y = (b[1] - oy) * iy, (b[4] - oy) * iy
                t0z, t1z = (b[2] - oz) * iz, (b[5] - oz) * iz
                tn = torch.maximum(
                    torch.maximum(torch.minimum(t0x, t1x),
                                  torch.minimum(t0y, t1y)),
                    torch.clamp(torch.minimum(t0z, t1z), min=0.0))
                tf = torch.minimum(
                    torch.minimum(torch.maximum(t0x, t1x),
                                  torch.maximum(t0y, t1y)),
                    torch.clamp(torch.maximum(t0z, t1z), max=1e30))
                ts.append(torch.where(tn <= tf, tn, -torch.inf))
                cs.append(torch.full((lanes,), k, device=dev))
            for a, b in sort8:
                swap = ts[a] < ts[b]
                ts[a], ts[b] = (torch.where(swap, ts[b], ts[a]),
                                torch.where(swap, ts[a], ts[b]))
                cs[a], cs[b] = (torch.where(swap, cs[b], cs[a]),
                                torch.where(swap, cs[a], cs[b]))
            c = c * 0.5 + torch.where(ts[0] > -torch.inf, ts[0] * 0.015625,
                                      0.0) + cs[7].to(torch.float32) * 0.0078125
        return c
    if name == "warp_vote":
        step = 0.125 + 0.25 * (lane & 3).to(torch.float32)
        for _ in range(iters):
            vote = (c > 1.5).reshape(-1, 32).any(1).repeat_interleave(32)
            c = torch.where(vote, c * 0.5 + 0.5, c + step)
        return c
    if name == "shared_stack":
        s = torch.zeros((lanes, STACK + 8), dtype=torch.int64, device=dev)
        s[:, 0] = lane & 15
        acc = torch.zeros_like(lane)
        for it in range(iters):
            sp = it % 40 + 1
            top = s[:, sp - 1].clone()
            for j in range(8):
                s[:, sp + j] = top + j + 1
            acc = acc + top
        return (acc & 0xFFFFF).to(torch.float32)
    raise ValueError(f"no micro-kernel {name!r}")


def time_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() (CUDA events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(name: str, table: torch.Tensor, iters: int = CHECK_ITERS) -> float:
    """Max |kernel - plain| of micro-kernel `name` at `iters` iterations;
    raises beyond rtol 1e-6 / atol 1e-6."""
    got, ref = run(name, table, iters), plain(name, table, iters)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, rtol=1e-6, atol=1e-6):
        raise RuntimeError(f"kernel lab {name}: kernel and plain version "
                           f"differ (max |diff| {err})")
    return err


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_lab needs a CUDA GPU")
    table = make_table("cuda")
    print(f"{torch.cuda.get_device_name(0)}; {LANES} lanes, "
          f"{args.iters} iterations")
    for name in KERNELS:
        err = check(name, table)
        ms = time_ms(lambda: run(name, table, args.iters))
        print(f"{name:14s} {ms * 1e3 / args.iters:9.4f} us/iter "
              f"({ms:.4f} ms; plain check at {CHECK_ITERS} iterations: max "
              f"|diff| {err:.3g})", flush=True)


if __name__ == "__main__":
    main()
