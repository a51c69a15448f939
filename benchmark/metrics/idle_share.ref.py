"""idle_share.ref: the share of a reference-mode render call's wall in
which no device event ran, in %: the device's busy time in the profiled
call (the union of its events) over the mean host wall of the window's
calls that ran without the profiler, whose host tracing stretches the
profiled call's own wall."""
from benchlib import profile


def read(ctx):
    st = ctx.stretch
    if ctx.mode != "reference" or st is None or not st.calls \
            or not ctx.call_s:
        return None
    busy_s = profile.busy_us(st) * 1e-6 / len(st.calls)
    return 100.0 * (1.0 - busy_s / ctx.call_s)
