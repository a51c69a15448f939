"""Readings for the limit of the correctness check, on the chip: for each
seed, one run of a cell as the benchmark makes it (the port's window and
its number against the reference), then the control, the same reference
computed with the scene's geometry, the environment and every ray and hit
through the trace rounded to bfloat16, put in the port's place and
compared the same way. From the root of a checkout:

    python3 benchmark/calibrate.py --workload art_ref_800x600 \\
        --seconds 10 --seeds 11 12 13

Prints one JSON line per seed: the port's numbers and the control's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent)]

import run  # noqa: E402
from benchlib import check  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    manifest = run.read_manifest()
    cell, traffic, cfg = run.load_cell(manifest, args.workload)
    mode = run.load_file(run.BENCH / "modes" / f"{traffic['mode']}.py",
                         "bench_mode")
    import types
    for seed in args.seeds:
        ctx = types.SimpleNamespace(
            workload=traffic, config=cfg, seed=seed, seconds=args.seconds,
            trace=False, device=args.device, t_process=time.perf_counter())
        res = mode.run(ctx)
        t = time.perf_counter()
        control = check.reference_pixels(**res["replay"], control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "calls": res["replay"]["calls"], "program": res["numbers"],
            "control": check.compare(control, res["reference"]),
            "control_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
