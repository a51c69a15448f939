"""Profiling and perf markers (counterpart of rtxpt_tpu/utils/profiling.py;
the reference's nested command-list perf markers around every pass,
Sample.cpp:2304,2371,2404-2413, and the CPU frame timer,
DeviceManager::UpdateAverageFrameTime, Sample.cpp:1556-1566). One tracing
system:

  * `span(name)` and `count(name, n)`: the program's own spans and
    counters. Off by default: `span` returns one shared no-op context after
    one flag check, `count` returns at once; nothing is allocated, no
    tensor touched, no device value read.
  * `record()`: turns them on for the block and yields the recorder, a
    `FrameProfiler`. Spans and counters then accumulate on the host clock
    with no device synchronize (only the set-up spans given `sync_on`
    synchronise), per top-level `render` call; while a `torch.profiler` is
    active each span is also a `record_function` range named
    `rtxpt:<name>`, in the profiler's trace beside the device events it
    launched. Counters take host integers only. One rendering thread.
  * `FrameProfiler.scope(name, sync_on=)`: the same span on a given
    recorder, used as a host-clock stage timer: where a tensor of
    `sync_on` (or `sync_on` itself, a torch.device) lies on a CUDA device
    it synchronises that device before reading the clock, so the stage's
    kernels are counted.
  * `trace(log_dir)`: a `torch.profiler` trace of the CPU and the CUDA
    device with recording on, written into `log_dir` as a Chrome trace
    (Perfetto or chrome://tracing; the Nsight slot).

The spans (the names PERF.md's layer table and the readers use):
`build/env`, `build/lights`, `build/omm`, `build/accel`, `build/tables`
(Renderer construction; synchronised); `render` (each Renderer.render
call and realtime frame: the call record), `entry` (pixel grid, camera,
init_paths, the wavefront's Morton sort), `bounce` (each iteration of the
bounce loop), `surface` (load_surface through update_outside_ior),
`shade` (the shade step, its NEE trace included), `regen` (path
regeneration), `compact` (narrowing and merging the wavefront),
`trace_closest` / `trace_anyhit` (ops/traverse.py), `sync` (every host
synchronisation on the reference path: a device value read, or a host
value copied to the device), `realtime/<stage>`. Counters: `bounce.live`
(live lanes of a bounce, as the loop's sync read them) and `bounce.width`
(the wavefront's lanes).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

PREFIX = "rtxpt:"
CALL = "render"

_NOOP = contextlib.nullcontext()
_recorder: Optional["FrameProfiler"] = None


def span(name: str, sync_on=None):
    """The program's span `name`: the shared no-op unless recording."""
    if _recorder is None:
        return _NOOP
    return _recorder.scope(name, sync_on)


def count(name: str, n: int):
    """Add the host integer `n` to the counter `name` while recording."""
    if _recorder is not None:
        _recorder.count(name, n)


@contextlib.contextmanager
def record(recorder: Optional["FrameProfiler"] = None):
    """Record the program's spans and counters in the block into
    `recorder` (a new FrameProfiler by default), which is yielded."""
    global _recorder
    rec = FrameProfiler() if recorder is None else recorder
    saved, _recorder = _recorder, rec
    try:
        yield rec
    finally:
        _recorder = saved


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


def _cuda_devices(sync_on):
    if isinstance(sync_on, torch.device):
        return {sync_on} if sync_on.type == "cuda" else set()
    return {t.device for t in _tensors(sync_on) if t.is_cuda}


@dataclasses.dataclass
class CallRecord:
    """One top-level `render` call (its index in `FrameProfiler.calls`
    identifies its spans): the call's wall in seconds, [count, total s,
    self s] per span name (self: less the time its child spans cover), the
    counters, and whether a torch.profiler was active during the call."""
    index: int
    wall: float = 0.0
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    profiled: bool = False


class _Span:
    __slots__ = ("rec", "name", "sync_on", "t0", "child", "ranged")

    def __init__(self, rec, name, sync_on):
        self.rec, self.name, self.sync_on = rec, name, sync_on
        self.child = 0.0
        self.ranged = None

    def __enter__(self):
        rec = self.rec
        profiled = torch._C._autograd._profiler_enabled()
        if profiled:
            self.ranged = torch.autograd.profiler.record_function(
                PREFIX + self.name)
            self.ranged.__enter__()
        if self.name == CALL and rec.call is None:
            rec.call = CallRecord(len(rec.calls))
            rec.call_span = self
        if profiled and rec.call is not None:
            rec.call.profiled = True
        rec.stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync_on is not None:
            for dev in _cuda_devices(self.sync_on):
                torch.cuda.synchronize(dev)
        dur = time.perf_counter() - self.t0
        rec = self.rec
        rec.stack.pop()
        if rec.stack:
            rec.stack[-1].child += dur
        rec.totals[self.name] += dur
        rec.counts[self.name] += 1
        call = rec.call
        if call is not None:
            s = call.spans.setdefault(self.name, [0, 0.0, 0.0])
            s[0] += 1
            s[1] += dur
            s[2] += dur - self.child
            if rec.call_span is self:
                call.wall = dur
                rec.calls.append(call)
                rec.call = rec.call_span = None
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        return False


class FrameProfiler:
    """The recorder: host-clock totals and counts per span name over
    everything recorded, the counters, and a CallRecord per top-level
    `render` call."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self.calls: List[CallRecord] = []
        self.call: Optional[CallRecord] = None     # the open call
        self.call_span: Optional[_Span] = None
        self.stack: List[_Span] = []

    def scope(self, name: str, sync_on=None) -> _Span:
        return _Span(self, name, sync_on)

    def count(self, name: str, n: int):
        self.counters[name] += n
        if self.call is not None:
            self.call.counters[name] = self.call.counters.get(name, 0) + n

    def report(self) -> str:
        lines = ["stage                          avg ms     calls"]
        for name, tot in sorted(self.totals.items(),
                                key=lambda kv: -kv[1]):
            c = self.counts[name]
            lines.append(f"{name:<28} {tot / max(c, 1) * 1e3:9.2f} {c:9d}")
        plain = [c for c in self.calls if not c.profiled]
        if plain:
            lines += self._call_table(plain)
        return "\n".join(lines)

    @staticmethod
    def _call_table(calls: List[CallRecord]) -> List[str]:
        """Per span name, the mean over `calls` of its count, total and
        self ms; then each counter's mean."""
        k = len(calls)
        names = sorted({n for c in calls for n in c.spans},
                       key=lambda n: -sum(c.spans.get(n, (0, 0, 0))[2]
                                          for c in calls))
        wall = sum(c.wall for c in calls) / k
        lines = [f"per render call ({k} calls, mean wall "
                 f"{wall * 1e3:.2f} ms):",
                 "span                      per call   total ms    self ms"]
        for n in names:
            cnt, tot, slf = (sum(c.spans.get(n, (0, 0, 0))[i]
                                 for c in calls) / k for i in range(3))
            lines.append(f"{n:<24} {cnt:10.1f} {tot * 1e3:10.2f} "
                         f"{slf * 1e3:10.2f}")
        for n in sorted({n for c in calls for n in c.counters}):
            lines.append(f"counter {n:<16} "
                         f"{sum(c.counters.get(n, 0) for c in calls) / k:.1f}")
        return lines


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the CPU and, where there is one, the CUDA
    device, with the program's spans recorded (`record`); on exit the
    Chrome trace is written into `log_dir` (created if missing) as
    rtxpt_trace_<ns>.json, its path in the yielded profiler's
    `trace_path`, and the recorder in its `recorder`."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof, record() as rec:
        prof.trace_path = os.path.join(
            log_dir, f"rtxpt_trace_{time.time_ns()}.json")
        prof.recorder = rec
        yield prof
    prof.export_chrome_trace(prof.trace_path)
