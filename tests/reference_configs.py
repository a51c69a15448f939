"""Renders of one reference-mode configuration by the port and by the
reference on the CPU, programmer-art at 16x12 with max_bounces=3, shared
by the parity tests of the shade chain, the distant samplers and ReGIR
(test_torch_shade_chain.py, test_torch_env_samplers.py,
test_torch_regir.py).

The reference runs its dense trace in interpret mode and its chain of
XLA ops for every bounce (RTXPT_SHADE_KERNEL=0), whatever the
configuration; the port takes the fused pass or its chain by the
reference's rule (pt/integrator.py `uses_shade_kernel`). Tolerance on the
HDR image: rtol 2e-4 / atol 5e-5, as tests/test_torch_integrator.py."""
import dataclasses

import numpy as np

W, H = 16, 12
RTOL, ATOL = 2e-4, 5e-5
# the last reference Renderer made, by its configuration less regir_layout
_LAST_REFERENCE = {}


def reference_env(monkeypatch):
    monkeypatch.setenv("RTXPT_SHADE_KERNEL", "0")
    monkeypatch.delenv("RTXPT_SHADE_KERNEL_INTERPRET", raising=False)
    monkeypatch.setenv("RTXPT_DENSE_INTERPRET", "1")


def render_pair(monkeypatch, spp: int, **cfg):
    """(reference image, port image) of reference_config(max_bounces=3,
    **cfg) at `spp` samples per pixel, as numpy (H, W, 3)."""
    from rtxpt_tpu.models.renderer import Renderer as JRenderer
    from rtxpt_tpu.models.renderer import reference_config as j_config
    from rtxpt_tpu.scene import envmap as JEM
    from rtxpt_tpu.scene import procedural as JP
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as TEM
    from rtxpt_tpu_torch.scene import procedural as TP

    reference_env(monkeypatch)
    # configurations that differ only in regir_layout share the reference's
    # Renderer, and so its compiled frame: of the reference, only the
    # Renderer's per-sample ReGIR build reads the layout
    # (rtxpt_tpu/models/renderer.py:203-218)
    j_cfg = j_config(max_bounces=3, **cfg)
    key = dataclasses.replace(j_cfg, regir_layout="grid")
    jr = _LAST_REFERENCE.get(key)
    if jr is None:
        jr = JRenderer(JP.build_programmer_art().finish(),
                       JP.default_camera(W, H), j_cfg,
                       env_radiance=JEM.bake_procedural_sky(height=32))
        _LAST_REFERENCE.clear()
        _LAST_REFERENCE[key] = jr
    jr.cfg = dataclasses.replace(jr.cfg, regir_layout=j_cfg.regir_layout)
    jr.accum = None
    ref = np.asarray(jr.render(W, H, spp))
    port = Renderer(TP.build_programmer_art().finish(),
                    TP.default_camera(W, H), reference_config(max_bounces=3,
                                                              **cfg),
                    env_radiance=TEM.bake_procedural_sky(height=32),
                    device="cpu")
    return ref, port.render(W, H, spp).numpy()


def assert_matches(ref, got):
    assert got.shape == ref.shape == (H, W, 3)
    assert np.isfinite(got).all() and got.mean() > 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
