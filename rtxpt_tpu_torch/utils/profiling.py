"""Profiling and perf markers (counterpart of rtxpt_tpu/utils/profiling.py;
the reference's nested command-list perf markers around every pass,
Sample.cpp:2304,2371,2404-2413, and the CPU frame timer,
DeviceManager::UpdateAverageFrameTime, Sample.cpp:1556-1566):

  * `FrameProfiler.scope(name, sync_on=)`: a host-clock stage timer; where
    a tensor of `sync_on` lies on a CUDA device it synchronises that
    device before reading the clock, so the stage's kernels are counted;
  * `trace(log_dir)`: a `torch.profiler` trace of the CPU and the CUDA
    device, written into `log_dir` as a Chrome trace (Perfetto or
    chrome://tracing; the Nsight slot);
  * `named_scope`: `torch.profiler.record_function`, which labels a stage
    in the profiler's output (models/realtime.py names its stages so).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

named_scope = torch.profiler.record_function


def _tensors(tree):
    """The tensors of a nest of tuples, lists and dicts."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class FrameProfiler:
    """Per-stage host-clock accumulation across frames."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in {t.device for t in _tensors(sync_on) if t.is_cuda}:
                torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage                          avg ms     calls"]
        for name, tot in sorted(self.totals.items(),
                                key=lambda kv: -kv[1]):
            c = self.counts[name]
            lines.append(f"{name:<28} {tot / max(c, 1) * 1e3:9.2f} {c:9d}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the CPU and, where there is one, the CUDA
    device; on exit the Chrome trace is written into `log_dir` (created if
    missing) as rtxpt_trace_<ns>.json, its path in the yielded profiler's
    `trace_path`."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        prof.trace_path = os.path.join(
            log_dir, f"rtxpt_trace_{time.time_ns()}.json")
        yield prof
    prof.export_chrome_trace(prof.trace_path)
