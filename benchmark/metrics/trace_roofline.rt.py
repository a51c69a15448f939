"""trace_roofline.rt: the least time the card needs for a realtime
frame's trace calls' work, counted from their arguments
(benchlib.peaks.trace_bytes at the HBM's peak, the work count of
trace_roofline.ref), over the device time of every kernel that starts
inside the trace calls, in %: the port's own `rtxpt:trace_*` spans where
the program records them, else the harness's ranges of the same calls."""
from benchlib import peaks, profile

PORT_RANGES = tuple("rtxpt:" + n for n in profile.TRACE_RANGES)


def read(ctx):
    st = ctx.stretch
    if ctx.mode != "realtime" or st is None or not st.trace_work:
        return None
    names = PORT_RANGES if any(st.spans.get(n) for n in PORT_RANGES) \
        else profile.TRACE_RANGES
    t_us = profile.inside_us(st, names)
    if t_us <= 0:
        return None
    work = sum(peaks.trace_bytes(name, n, ctx.triangles)
               for name, n in st.trace_work)
    return 100.0 * work / peaks.HBM_BYTES_PER_S / (t_us * 1e-6)
