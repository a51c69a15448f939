"""Row-window addressing of per-pixel buffers (counterpart of
rtxpt_tpu/restir/window.py). Every ReSTIR cross-pixel gather (temporal
reprojection, spatial taps) addresses its buffers through this helper. A
buffer holds `rows` rows of the frame starting at global row `y0`; the
single-device frame is the window y0 = 0, rows = the frame's height."""
import torch


def window_flat(ix, iy, width: int, y0: int, rows: int, gheight: int):
    """Flat index into a row-window buffer laid out (rows * width, ...)
    with global row y0 at local row 0; ix, iy are global pixel coordinates,
    clamped to the window rows that lie inside the frame."""
    ixc = torch.clamp(ix, 0, width - 1)
    lo = max(y0, 0)
    hi = min(y0 + rows, gheight) - 1
    iyc = torch.clamp(iy, lo, hi)
    return (iyc - y0) * width + ixc
