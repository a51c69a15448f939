"""Path tracer configuration (counterpart of rtxpt_tpu/config.py):
`PTConfig`, the settings a cell's configuration file gives, with the
reference's reference-mode defaults (SampleUI.h:149-167), and `PTConstants`,
the per-frame constants (SampleConstantBuffer.h PathTracerConstants).

The plain reference implements one choice of each of the port's other
settings: NEE on, the MIP-descent distant sampler through the alias rows,
the power-weighted local sampler, the "ld" sample generator, the fused
shade+NEE pass, no exact alpha test. A setting it does not carry is
refused as an unknown keyword.
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


@dataclasses.dataclass(frozen=True)
class PTConstants:
    """Per-frame dynamic constants (SampleConstantBuffer.h:20-46)."""
    firefly_filter_threshold: float = 0.0   # 0 disables (Sample.cpp:1605)
    nee_min_radiance_threshold: float = 1e-5
    sample_base_index: int = 0              # accumulation sample index
    noisy_radiance_attenuation: float = 1.0
