"""Path tracer configuration (counterpart of rtxpt_tpu/config.py).

`PTConfig` is the static configuration and `PTConstants` the per-frame
constants (SampleConstantBuffer.h PathTracerConstants), both plain
dataclasses of python scalars. The port carries the reference-mode and
realtime fields its render modes read, with the reference's defaults; it
always samples the environment with the MIP-descent distribution,
low-discrepancy sample streams and the fused shade+NEE pass (the
reference's defaults for those switches).
"""
from __future__ import annotations

import dataclasses

# Path tracer modes (reference: PathTracer/Config.h:41-43)
MODE_REFERENCE = 0
MODE_BUILD_STABLE_PLANES = 1
MODE_FILL_STABLE_PLANES = 2


@dataclasses.dataclass(frozen=True)
class PTConfig:
    mode: int = MODE_REFERENCE
    max_bounces: int = 30                 # SampleUI BounceCount default
    max_diffuse_bounces: int = 6          # reference-mode default (UI:163)
    nee_distant_samples: int = 2          # SampleUI.h:149
    nee_local_samples: int = 2            # SampleUI.h:152
    enable_russian_roulette: bool = True
    use_env_lights: bool = True           # PathTracer.hlsli:22
    use_emissive_lights: bool = True
    stable_plane_count: int = 3           # Config.h:81
    use_stable_planes: bool = False       # realtime: 3-plane BUILD/FILL
    #   decomposition (False = the single-plane PSR-lite G-buffer)
    max_stable_plane_vertex_depth: int = 6
    # realtime pipeline stages
    use_restir_di: bool = False
    use_restir_gi: bool = False
    denoiser_enabled: bool = False
    realtime_noise: bool = True           # Sample.cpp:1572 determinism switch
    denoiser_method: str = "relax"        # NRD slot: "relax" (or "reblur")
    # per-bounce wavefront reorder (SER's coherence reorder; the sort keys
    # of pt/integrator.py `wavefront_sort_key`): "none" keeps the morton
    # primary order; "octant" sorts live lanes by direction octant;
    # "material" by the last shaded material id; "raystream" by the
    # morton code of the new ray's origin cell and its octant, so that
    # the dense trace's tiles (whose cost is the union of their rays'
    # cluster worklists) hold rays from one scene cell heading one way.
    # Compaction runs only under "none".
    wavefront_sort: str = "none"
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
