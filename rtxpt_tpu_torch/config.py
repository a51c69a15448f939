"""Path tracer configuration (counterpart of rtxpt_tpu/config.py).

`PTConfig` is the static configuration and `PTConstants` the per-frame
constants (SampleConstantBuffer.h PathTracerConstants), both plain
dataclasses of python scalars. The port carries the reference-mode fields
the slice reads, with the reference's defaults; it always samples the
environment with the MIP-descent distribution, low-discrepancy sample
streams and the fused shade+NEE pass, and never re-sorts the wavefront
(the reference's defaults for those switches).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PTConfig:
    max_bounces: int = 30                 # SampleUI BounceCount default
    max_diffuse_bounces: int = 6          # reference-mode default (UI:163)
    nee_distant_samples: int = 2          # SampleUI.h:149
    nee_local_samples: int = 2            # SampleUI.h:152
    enable_russian_roulette: bool = True
    use_env_lights: bool = True           # PathTracer.hlsli:22
    use_emissive_lights: bool = True
    # width compaction of wide wavefronts (pt/integrator.py): tail
    # compaction of single-sample waves, staged compaction of regenerating
    # waves, for wavefronts at least wavefront_compaction_min lanes wide
    wavefront_compaction: bool = True
    wavefront_compaction_min: int = 16384


@dataclasses.dataclass(frozen=True)
class PTConstants:
    """Per-frame dynamic constants (SampleConstantBuffer.h:20-46)."""
    firefly_filter_threshold: float = 0.0   # 0 disables (Sample.cpp:1605)
    nee_min_radiance_threshold: float = 1e-5
    sample_base_index: int = 0              # accumulation sample index
    noisy_radiance_attenuation: float = 1.0


def default_constants(sample_base_index: int = 0) -> PTConstants:
    return PTConstants(sample_base_index=int(sample_base_index))
