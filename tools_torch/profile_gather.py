"""Row-gather lab: the surface fetch, K2 and K3 (``csrc/gather.cu``) on
the first-bounce inputs of the four main paths, against the kernels of
another checkout of the port (an earlier commit's gather.cu, built into a
library of its own) on the same inputs, in one process on one card.

    python -m tools_torch.profile_gather --parent DIR

DIR is the root of the other checkout (its ``rtxpt_tpu_torch/csrc`` must
hold a gather.cu whose C entry points ``rtxpt_gather_rows`` and
``rtxpt_gather_rows_interp`` take no word-size argument, as before the
surface fetch). Without --parent only this tree's kernels are timed.

Paths (chip_smoke.py's): bench (programmer-art 800x600, bench config,
the first bounce of one sample), city (1920x1080), realtime city
(1920x1080) and realtime 360p (programmer-art 640x360; both the first
FILL bounce of a default realtime frame). On each: the surface fetch,
and the four-launch composition it replaced (K2, K3, K2, K2 and the
PyTorch ops between, chip_smoke.py `parent_surface`) on this tree's and
on the other checkout's K2/K3, all bit-equal; K2 on each distinct table
the path gathers from (those inside the surface fetch included) with
torch.index_select beside it; K3 on the surface fetch's blend. Times are
device times (chip_smoke.py `device_ms`: a CUDA graph of the launches
replayed, no host time between launches) with the CUDA-event times of
launches from the host (which include it) in brackets; bounds as
chip_smoke.py counts them. Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

import chip_smoke as CS
from rtxpt_tpu_torch.ops import cuda_lib, gather

P, I = ctypes.c_void_p, ctypes.c_int
# the C entry points of gather.cu before the word-size argument
PARENT_SIGNATURES = {"rtxpt_gather_rows": (P, I, I, P, P, I, P),
                     "rtxpt_gather_rows_interp": (P, I, I, P, P, P, I, P)}


class ParentKernels:
    """K2 and K3 of another checkout, called as that checkout's wrappers
    called them."""

    def __init__(self, root: Path):
        self.lib = cuda_lib.load("rtxpt_gather_parent", ("gather.cu",),
                                 PARENT_SIGNATURES,
                                 csrc=root / "rtxpt_tpu_torch" / "csrc")

    def rows(self, table, idx):
        flat = idx.reshape(-1).to(torch.int32).contiguous()
        rows, width = table.shape
        out = torch.empty((flat.shape[0], width), dtype=table.dtype,
                          device=table.device)
        cuda_lib.launch("rtxpt_gather_rows", table.data_ptr(), rows, width,
                        flat.data_ptr(), out.data_ptr(), flat.shape[0],
                        library=self.lib)
        return out.reshape(*idx.shape, width)

    def interp(self, table, idx3, w3):
        i3 = idx3.to(torch.int32).contiguous()
        rows, width = table.shape
        out = torch.empty((i3.shape[0], width), dtype=torch.float32,
                          device=table.device)
        cuda_lib.launch("rtxpt_gather_rows_interp", table.data_ptr(), rows,
                        width, i3.data_ptr(), w3.data_ptr(), out.data_ptr(),
                        i3.shape[0], library=self.lib)
        return out


def capture(path: str):
    """(the first captured surface fetch's args, the captured K2 calls,
    the lane count K2 calls are kept at (None: all)) of one path."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    limits = dict(gather_rows=16, gather_surface=1)
    if path in ("bench", "city"):
        w, h = (800, 600) if path == "bench" else (1920, 1080)
        host = procedural.build_programmer_art().finish() \
            if path == "bench" else CS.build_city()
        cam = procedural.default_camera(w, h) if path == "bench" \
            else procedural.city_camera(w, h)
        cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                               nee_distant_samples=1, nee_local_samples=1)
        r = Renderer(host, cam, cfg,
                     env_radiance=EM.bake_procedural_sky(height=64),
                     device="cuda")
        with CS.Capture(limits) as cap:
            r.render_sample(w, h, 0)
            torch.cuda.synchronize()
        lanes = w * h if path == "bench" else None
    else:
        city = path == "realtime_city"
        w, h = (1920, 1080) if city else (640, 360)
        host = CS.build_city() if city \
            else procedural.build_programmer_art().finish()
        cam = procedural.city_camera(w, h) if city \
            else procedural.default_camera(w, h)
        r = RealtimeRenderer(host, cam, device="cuda")
        with CS.Capture(limits, during=("fill",)) as cap:
            r.render_frame(w, h)
            torch.cuda.synchronize()
        lanes = None
    return cap.calls["gather_surface"][0][0], cap.calls["gather_rows"], lanes


def both(fn) -> tuple:
    """(device ms, CUDA-event ms) of fn()."""
    return CS.device_ms(fn), CS.time_ms(fn, 50)


def fmt(t) -> str:
    return f"{t[0]:.4f} ({t[1]:.4f})"


def run_path(path: str, parent) -> dict:
    args, k2_calls, lanes = capture(path)
    k2_inside, k3_args = CS.surface_inputs(args)
    out = {"path": path, "lanes": args[4].shape[0]}
    got = gather.gather_surface(*args)
    comps = {"this tree": lambda: CS.parent_surface(*args)}
    if parent:
        comps["other checkout"] = lambda: CS.parent_surface(
            *args, rows=parent.rows, interp=parent.interp)
    for name, fn in comps.items():
        CS.require(all(torch.equal(a, b) for a, b in zip(got, fn())),
                   f"{path}: the composition on {name}'s K2/K3 differs")
    out["surface"] = both(lambda: gather.gather_surface(*args))
    out["composition"] = {name: both(fn) for name, fn in comps.items()}
    print(f"{path} surface fetch, {out['lanes']} lanes: kernel "
          f"{fmt(out['surface'])} ms; the composition it replaced on "
          + ", ".join(f"{name}'s K2/K3 {fmt(t)} ms"
                      for name, t in out["composition"].items()), flush=True)

    seen, out["k2"] = set(), []
    for (table, idx), _ in k2_calls + k2_inside:
        key = (tuple(table.shape), table.dtype, idx.numel())
        if (lanes is not None and idx.numel() != lanes) or key in seen:
            continue
        seen.add(key)
        safe = torch.clamp(idx.reshape(-1), 0, table.shape[0] - 1)
        row = {"table": list(table.shape), "dtype": str(table.dtype),
               "rows": idx.numel(), "instance": gather.instance(table),
               "kernel": both(lambda: gather.gather_rows(table, idx)),
               "index_select": both(
                   lambda: torch.index_select(table, 0, safe))}
        nbytes = (torch.unique(safe).numel() + idx.numel()) \
            * table.shape[1] * table.element_size() \
            + idx.numel() * idx.element_size()
        row["bound_ms"] = CS.bound(nbytes, 0)[0]
        if parent:
            CS.require(torch.equal(parent.rows(table, idx),
                                   gather.gather_rows(table, idx)),
                       f"{path}: the other checkout's K2 differs")
            row["other"] = both(lambda: parent.rows(table, idx))
        out["k2"].append(row)
        print(f"{path} K2 {tuple(table.shape)} {table.dtype} x "
              f"{idx.numel()} ({row['instance']}): kernel "
              f"{fmt(row['kernel'])} ms"
              + (f", other checkout {fmt(row['other'])} ms" if parent
                 else "")
              + f", index_select {fmt(row['index_select'])} ms, bound "
              f"{row['bound_ms']:.4f} ms", flush=True)

    out["k3"] = {"kernel": both(lambda: gather.gather_rows_interp(
        *k3_args))}
    if parent:
        out["k3"]["other"] = both(lambda: parent.interp(*k3_args))
    print(f"{path} K3 {k3_args[1].shape[0]} lanes: kernel "
          f"{fmt(out['k3']['kernel'])} ms"
          + (f", other checkout {fmt(out['k3']['other'])} ms" if parent
             else ""), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("rtxpt_tpu_torch row-gather lab")
    p.add_argument("--parent", type=Path, default=None,
                   help="root of another checkout whose K2/K3 to time")
    p.add_argument("--paths", default="bench,city,realtime_city,"
                   "realtime_360p")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_gather: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(CS.card_line(), flush=True)
    parent = ParentKernels(args.parent.resolve()) if args.parent else None
    results = []
    for path in args.paths.split(","):
        results.append(run_path(path, parent))
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
