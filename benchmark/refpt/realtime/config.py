"""The realtime configuration of the plain reference: `RTConfig`, the
settings a realtime cell's configuration file gives, with the port's
realtime defaults (`realtime_config` with ReSTIR DI and GI, the denoiser
and stable planes on: SampleUI.h:158-168, Config.h:81). A setting the
plain reference does not carry is refused as an unknown keyword; a
carried one set to a value other than the one it implements is refused
by `check`."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RTConfig:
    max_bounces: int = 30
    max_diffuse_bounces: int = 3          # realtime default (UI:158-168)
    nee_distant_samples: int = 2
    nee_local_samples: int = 2
    enable_russian_roulette: bool = True
    use_stable_planes: bool = True        # Config.h:81
    stable_plane_count: int = 3
    max_stable_plane_vertex_depth: int = 6
    use_restir_di: bool = True
    use_restir_gi: bool = True
    denoiser_enabled: bool = True
    denoiser_method: str = "relax"
    realtime_noise: bool = True

    def check(self) -> "RTConfig":
        fixed = dict(use_stable_planes=True, use_restir_di=True,
                     use_restir_gi=True, denoiser_enabled=True,
                     denoiser_method="relax", realtime_noise=True)
        bad = {k: getattr(self, k) for k, v in fixed.items()
               if getattr(self, k) != v}
        if bad:
            raise ValueError(f"the plain realtime reference implements "
                             f"{fixed}, not {bad}")
        if not 1 <= self.stable_plane_count <= 3:
            raise ValueError("stable_plane_count must be 1 to 3")
        return self
