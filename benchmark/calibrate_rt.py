"""Readings for the limits of the realtime check, on the chip: for each
seed, one run of a realtime cell as the benchmark makes it (the port's
window, its check frame and the numbers of the replay against it), then
the control, the same replay with the scene's geometry, the environment
and every ray and hit through the trace rounded to bfloat16. From the
root of a checkout:

    python3 benchmark/calibrate_rt.py --workload city_rt_1080p \\
        --seconds 10 --seeds 11 12 13

Prints one JSON line per seed: the port's numbers and the control's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent)]

import run  # noqa: E402
from benchlib import check_rt  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate_rt: needs a CUDA device", file=sys.stderr)
        return 2
    _, traffic, cfg = run.load_cell(run.read_manifest(), args.workload)
    if traffic["mode"] != "realtime":
        print(f"calibrate_rt: {args.workload} is not a realtime cell",
              file=sys.stderr)
        return 2
    mode = run.load_file(run.BENCH / "modes" / "realtime.py", "bench_mode")
    for seed in args.seeds:
        ctx = types.SimpleNamespace(
            workload=traffic, config=cfg, seed=seed, seconds=args.seconds,
            trace=False, device=args.device, t_process=time.perf_counter())
        res = mode.run(ctx)
        t = time.perf_counter()
        control = check_rt.replay(**res["replay"], control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "frames": res["attempted"], "program": res["numbers"],
            "correct": res["correct"], "control": control,
            "control_correct": check_rt.verdict(control),
            "control_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
