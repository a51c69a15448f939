"""Reduction of a `torch.profiler` trace of a profiled stretch to the
numbers the per-layer readers and the result's `device` and `breakdown`
need. The arithmetic follows the port's development tool
`tools_torch/profile_render.py`: device events by kernel, the device-side
spans of host ranges, and the device time of the kernels that start
inside a span.

Times are in microseconds on the profiler's clock, on which the host's
ranges and the device's events lie together."""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

CALL_RANGE = "bench:call"                  # one render call (harness)
TRACE_RANGES = ("trace_closest", "trace_anyhit")   # the port's trace calls
HOST_RANGES = (CALL_RANGE,) + TRACE_RANGES

Interval = Tuple[float, float, str]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass
class Stretch:
    """A profiled stretch of `calls` render calls."""
    ops: List[Interval]                    # every device event (kernels,
    #                                        copies and sets)
    spans: Dict[str, List[Tuple[float, float]]]   # device-side spans by
    #                                               range name
    host: List[Interval]                   # host events (ops and ranges)
    calls: List[Tuple[float, float]]       # host spans of the calls
    trace_work: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)              # (range name, active rays) of
    #                                        each trace call

    @property
    def kernels(self) -> List[Interval]:
        return [o for o in self.ops if not is_copy(o[2])]

    @property
    def wall_us(self) -> float:
        return sum(e - s for s, e in self.calls)


HOST_MIN_US = 20.0     # shorter host events cannot name an idle gap


def from_profiler(prof, calls_name: str = CALL_RANGE) -> Stretch:
    """A Stretch from a finished `torch.profiler.profile`, read from its
    raw Kineto events (building `prof.events()` takes minutes for the
    hundreds of thousands of launches of one call). Host events shorter
    than HOST_MIN_US are dropped, except the harness's and trace ranges."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    t0 = min((e.start_ns() for e in raw), default=0)
    ops, spans, host, calls = [], {}, [], []
    for e in raw:
        name = e.name()
        s = (e.start_ns() - t0) * 1e-3
        t = (e.end_ns() - t0) * 1e-3
        if e.device_type() == cuda:
            if name in HOST_RANGES:
                spans.setdefault(name, []).append((s, t))
            else:
                ops.append((s, t, name))
            continue
        if name in HOST_RANGES or t - s >= HOST_MIN_US:
            host.append((s, t, name))
        if name == calls_name:
            calls.append((s, t))
    ops.sort()
    host.sort()
    calls.sort()
    for v in spans.values():
        v.sort()
    return Stretch(ops, spans, host, calls)


def union(intervals) -> List[Tuple[float, float]]:
    """Merged, sorted (start, end) of intervals given as (start, end, ...)."""
    out = []
    for iv in sorted(intervals):
        s, e = iv[0], iv[1]
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_us(st: Stretch) -> float:
    """Time in which some device event ran, inside the calls' host spans."""
    busy = 0.0
    for s, e in union(st.ops):
        for c0, c1 in st.calls:
            busy += max(0.0, min(e, c1) - max(s, c0))
    return busy


def idle_gaps(st: Stretch) -> List[Tuple[float, float]]:
    """The device's idle intervals inside the calls' host spans."""
    merged = union(st.ops)
    gaps = []
    for c0, c1 in st.calls:
        t = c0
        for s, e in merged:
            if e <= c0 or s >= c1:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < c1:
            gaps.append((t, c1))
    return gaps


def inside_us(st: Stretch, names) -> float:
    """Device time of the kernels and copies that start inside the
    device-side spans of the ranges `names`."""
    spans = sorted(sp for n in names for sp in st.spans.get(n, ()))
    starts = [s for s, _ in spans]
    total = 0.0
    for s, e, _ in st.ops:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < spans[i][1]:
            total += e - s
    return total


def _host_name(st: Stretch, t: float) -> str:
    """What the host was doing at t: the innermost harness or trace range
    and the outermost other host event around t."""
    rng, op, op_len = "", "python", -1.0
    for s, e, name in st.host:
        if s > t:
            break
        if e < t:
            continue
        if name in HOST_RANGES:
            rng = name
        elif e - s > op_len:
            op, op_len = name, e - s
    return f"{rng}/{op}" if rng else op


def breakdown(st: Stretch, top: int = 10) -> dict:
    """The device operations that took the most time, and the longest idle
    gaps named by the host activity at their start, in seconds."""
    by_name: Dict[str, float] = {}
    for s, e, name in st.ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(st), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:200], v * 1e-6] for n, v in ops],
            "idle_gaps": [[_host_name(st, s), (e - s) * 1e-6]
                          for s, e in gaps]}
