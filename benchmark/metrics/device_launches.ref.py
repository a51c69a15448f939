"""device_launches.ref: device kernels per reference-mode render call in
the profiled stretch, PyTorch's and the port's alike (copies and sets
left out)."""


def read(ctx):
    st = ctx.stretch
    if ctx.mode != "reference" or st is None or not st.calls:
        return None
    return len(st.kernels) / len(st.calls)
