"""fill_device_ms.rt: device ms per realtime frame of the kernels and
copies that start inside the port's FILL span (`rtxpt:realtime/fill`:
the bounce loop from the plane-0 base, K4 FILL, its traces and surface
fetches)."""
from benchlib import profile

SPANS = ("rtxpt:realtime/fill",)


def read(ctx):
    st = ctx.stretch
    if ctx.mode != "realtime" or st is None or not st.calls \
            or not st.spans.get(SPANS[0]):
        return None
    return profile.inside_us(st, SPANS) * 1e-3 / len(st.calls)
