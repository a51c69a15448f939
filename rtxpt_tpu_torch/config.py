"""Path tracer configuration (counterpart of rtxpt_tpu/config.py).

`PTConfig` is the static configuration and `PTConstants` the per-frame
constants (SampleConstantBuffer.h PathTracerConstants), both plain
dataclasses of python scalars. The port carries the reference's fields
with the reference's defaults: NEE on or off, the distant sampler
(uniform, MIP-descent or presampled), the local sampler (power or
ReGIR, grid or onion cells), the sample-generator tier ("ld", "hq" or
"uniform"), the fused shade+NEE switch and the exact alpha test of
visibility rays. It leaves out the reference's `use_analytic_lights` and
`PTConstants.texlod_bias`, which the reference reads nowhere.
`apply_scene_settings` applies a .scene.json's settings.
"""
from __future__ import annotations

import dataclasses

# Path tracer modes (reference: PathTracer/Config.h:41-43)
MODE_REFERENCE = 0
MODE_BUILD_STABLE_PLANES = 1
MODE_FILL_STABLE_PLANES = 2

# NEE distant sampler types (SampleUI.h:147)
NEE_DISTANT_UNIFORM = 0
NEE_DISTANT_MIP_DESCENT = 1
NEE_DISTANT_PRESAMPLED = 2

# NEE local sampler types (SampleUI NEELocalType)
NEE_LOCAL_POWER = 1
NEE_LOCAL_REGIR = 2
RNG_QUALITIES = ("ld", "hq", "uniform")


@dataclasses.dataclass(frozen=True)
class PTConfig:
    mode: int = MODE_REFERENCE
    max_bounces: int = 30                 # SampleUI BounceCount default
    max_diffuse_bounces: int = 6          # reference-mode default (UI:163)
    nee_enabled: bool = True
    nee_distant_type: int = NEE_DISTANT_MIP_DESCENT
    nee_distant_samples: int = 2          # SampleUI.h:149
    nee_local_samples: int = 2            # SampleUI.h:152
    nee_local_type: int = NEE_LOCAL_POWER
    regir_layout: str = "grid"            # "grid" | "onion" (camera-centred
    #   log shells, LightSamplingLocal.hlsli:555)
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
    # the fused shade+NEE pass (K4, pt/shade_kernel.py); the bounce takes
    # it when NEE is on, local sampling is not ReGIR and the tier is "ld"
    # (pt/integrator.py `uses_shade_kernel`), else the chain of tensor ops
    shade_megakernel: bool = True
    # sample-generator tier: "ld" Owen-scrambled Sobol' (default), "hq"
    # the hash streams with the extra output mixing round
    # (StatelessHQUniformSampleGenerator.hlsli:20), "uniform" the plain
    # hash streams
    rng_quality: str = "ld"
    # the exact per-hit texture alpha test of visibility rays that hit
    # alpha-MASK materials (pt/visibility.py); the Renderer clears it for
    # scenes without a MASK material with textures
    exact_alpha_test: bool = True


@dataclasses.dataclass(frozen=True)
class PTConstants:
    """Per-frame dynamic constants (SampleConstantBuffer.h:20-46)."""
    firefly_filter_threshold: float = 0.0   # 0 disables (Sample.cpp:1605)
    nee_min_radiance_threshold: float = 1e-5
    sample_base_index: int = 0              # accumulation sample index
    noisy_radiance_attenuation: float = 1.0


def default_constants(sample_base_index: int = 0) -> PTConstants:
    return PTConstants(sample_base_index=int(sample_base_index))


def apply_scene_settings(cfg: PTConfig, settings: dict) -> PTConfig:
    """A .scene.json SampleSettings node (ExtendedScene.h:83, consumed at
    Sample.cpp:629-649) applied to cfg: its reference names or PTConfig
    field names; other keys are ignored, as in the reference."""
    mapping = {
        "MaxBounces": "max_bounces",
        "MaxDiffuseBounces": "max_diffuse_bounces",
        "RealtimeMode": None,
        "EnableRussianRoulette": "enable_russian_roulette",
    }
    names = {f.name for f in dataclasses.fields(cfg)}
    updates = {}
    for k, v in settings.items():
        field = mapping.get(k, k if k in names else None)
        if field:
            updates[field] = v
    return dataclasses.replace(cfg, **updates) if updates else cfg
