"""device_launches.rt: device kernels per realtime frame in the profiled
stretch, PyTorch's and the port's alike (copies and sets left out)."""


def read(ctx):
    st = ctx.stretch
    if ctx.mode != "realtime" or st is None or not st.calls:
        return None
    return len(st.kernels) / len(st.calls)
