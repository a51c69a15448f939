"""denoise_device_ms.rt: device ms per realtime frame of the kernels and
copies that start inside the port's denoiser and TAA spans
(`rtxpt:realtime/relax`, `rtxpt:realtime/taa`)."""
from benchlib import profile

SPANS = ("rtxpt:realtime/relax", "rtxpt:realtime/taa")


def read(ctx):
    st = ctx.stretch
    if ctx.mode != "realtime" or st is None or not st.calls \
            or not any(st.spans.get(n) for n in SPANS):
        return None
    return profile.inside_us(st, SPANS) * 1e-3 / len(st.calls)
