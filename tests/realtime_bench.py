"""Helpers of the tests of the benchmark's realtime cell on the CPU: the
benchmark's folder on sys.path (as `python3 benchmark/run.py` puts it),
the cell's configuration moved to programmer-art at a small size, and a
run of the realtime mode (benchmark/modes/realtime.py)."""
import json
import sys
import time
import types
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import run  # noqa: E402

CELL = "city_rt_1080p"
W, H = 16, 12
MAX_BOUNCES = 3


def cell_files():
    """(traffic, configuration) of the realtime cell, on programmer-art
    at W x H with MAX_BOUNCES bounces and two warm-up frames."""
    _, traffic, cfg = run.load_cell(run.read_manifest(), CELL)
    art = json.loads((BENCH / "configs" / "programmer_art.json").read_text())
    cfg = dict(art, settings=dict(cfg["settings"], max_bounces=MAX_BOUNCES))
    traffic = dict(traffic, width=W, height=H, warmup_frames=2,
                   check={"pixels": 64})
    return traffic, cfg


def run_mode(seed: int = 5, seconds: float = 0.0, trace: bool = False):
    """The realtime mode's result dict on the CPU."""
    torch.set_num_threads(4)
    traffic, cfg = cell_files()
    ctx = types.SimpleNamespace(workload=traffic, config=cfg, seed=seed,
                                seconds=seconds, trace=trace, device="cpu",
                                t_process=time.perf_counter())
    mode = run.load_file(BENCH / "modes" / "realtime.py",
                         "bench_mode_realtime")
    return mode.run(ctx)
