"""fill_lane_occupancy.rt: the share of FILL's wavefront lanes that were
live, over the profiled frame's bounces, in %: the port's counters
`bounce.live` over `bounce.width` (in a realtime frame only FILL runs the
bounce loop), recorded by `profiling.record()`."""


def read(ctx):
    st = ctx.stretch
    counters = getattr(st, "counters", None) or {}
    if ctx.mode != "realtime" or not counters.get("bounce.width"):
        return None
    return 100.0 * counters.get("bounce.live", 0) / counters["bounce.width"]
