"""restir_device_ms.rt: device ms per realtime frame of the kernels and
copies that start inside the port's ReSTIR DI and GI spans
(`rtxpt:realtime/restir_di`, `rtxpt:realtime/restir_gi`: candidates,
temporal and spatial reuse, the fused final shading and its visibility
trace)."""
from benchlib import profile

SPANS = ("rtxpt:realtime/restir_di", "rtxpt:realtime/restir_gi")


def read(ctx):
    st = ctx.stretch
    if ctx.mode != "realtime" or st is None or not st.calls \
            or not any(st.spans.get(n) for n in SPANS):
        return None
    return profile.inside_us(st, SPANS) * 1e-3 / len(st.calls)
