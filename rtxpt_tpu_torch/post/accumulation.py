"""Reference-mode progressive accumulation (counterpart of
rtxpt_tpu/post/accumulation.py; AccumulationPass.hlsl:24-53): running mean
via lerp(prev, new, 1/(N+1))."""
from __future__ import annotations


def accumulate(prev, new, sample_index: int):
    """prev/new: (...,3) tensors; sample_index: 0 for the first sample."""
    w = 1.0 / (float(sample_index) + 1.0)
    return prev + (new - prev) * w
