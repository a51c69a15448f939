"""trace_roofline.ref: the least time the card needs for the trace calls'
work, counted from their arguments (benchlib.peaks.trace_bytes at the
HBM's peak), over the device time of every kernel that starts inside the
port's trace_closest / trace_anyhit calls, in %. A loose floor: it counts
each ray, hit and triangle once."""
from benchlib import peaks, profile


def read(ctx):
    st = ctx.stretch
    if ctx.mode != "reference" or st is None or not st.trace_work:
        return None
    t_us = profile.inside_us(st, profile.TRACE_RANGES)
    if t_us <= 0:
        return None
    work = sum(peaks.trace_bytes(name, n, ctx.triangles)
               for name, n in st.trace_work)
    return 100.0 * work / peaks.HBM_BYTES_PER_S / (t_us * 1e-6)
