"""The chain of tensor ops that shades a bounce where the fused shade+NEE
pass (K4) does not (pt/integrator.py `_chain_shade_step`): the port
against the reference's XLA chain on the CPU (tests/reference_configs.py)
for shade_megakernel=False at NEE 2+2, NEE off and the "hq" and
"uniform" sample-generator tiers, and for the realtime FILL pass; the
chain against K4's plain version in the port; the tiers' streams bit for
bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_configs import (ATOL, RTOL, H, W, assert_matches,
                               reference_env, render_pair)
from rtxpt_tpu.core import rng as JR
from rtxpt_tpu_torch.core import rng as TR
from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.pt import integrator as TI
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import procedural as TP

CONFIGS = {
    "chain NEE 2+2, 2 spp": (2, dict(shade_megakernel=False)),
    "NEE off": (1, dict(nee_enabled=False)),
    "hq": (1, dict(rng_quality="hq")),
    "uniform": (1, dict(rng_quality="uniform")),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chain_configuration_matches_reference(monkeypatch, name):
    spp, cfg = CONFIGS[name]
    assert not TI.uses_shade_kernel(reference_config(**cfg), 2)
    assert_matches(*render_pair(monkeypatch, spp, **cfg))


def test_rule_picks_the_fused_pass():
    """The reference's rule (rtxpt_tpu/pt/integrator.py:620-624)."""
    cfg = reference_config()
    assert TI.uses_shade_kernel(cfg, 2)
    assert TI.uses_shade_kernel(dataclasses.replace(cfg, nee_distant_type=0),
                                2)
    assert TI.uses_shade_kernel(dataclasses.replace(cfg, nee_local_type=2), 0)
    for off in (dict(nee_local_type=2), dict(shade_megakernel=False),
                dict(nee_enabled=False), dict(rng_quality="hq"),
                dict(rng_quality="uniform")):
        assert not TI.uses_shade_kernel(dataclasses.replace(cfg, **off), 2)


def test_unknown_rng_quality_raises():
    r = Renderer(TP.build_programmer_art().finish(), TP.default_camera(W, H),
                 reference_config(max_bounces=1, rng_quality="sobol"),
                 env_radiance=TEM.bake_procedural_sky(height=32),
                 device="cpu")
    with pytest.raises(ValueError, match="rng_quality"):
        r.render_sample(W, H, 0)


@pytest.mark.parametrize("nee", [(2, 2), (1, 0)])
def test_chain_matches_fused_plain_version(nee):
    """The chain and K4's plain version render the same image for the
    same configuration (the reference's kernel-vs-chain tolerance,
    tests/test_shade_kernel.py:37)."""
    host = TP.build_programmer_art().finish()
    imgs = []
    for fused in (True, False):
        cfg = reference_config(max_bounces=3, shade_megakernel=fused,
                               nee_distant_samples=nee[0],
                               nee_local_samples=nee[1])
        assert TI.uses_shade_kernel(cfg, nee[1]) == fused
        r = Renderer(host, TP.default_camera(W, H), cfg,
                     env_radiance=TEM.bake_procedural_sky(height=32),
                     device="cpu")
        imgs.append(r.render(W, H, 2).numpy())
    np.testing.assert_allclose(imgs[1], imgs[0], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("tier", ["ld", "hq", "uniform"])
def test_tier_streams_bit_exact(tier):
    """The bounce's generator (seeded with the lane's accumulation
    sample) and its scatter stream, whose low discrepancy only the "ld"
    tier keeps, against the reference's sample_gen (integrator.py:470-479,
    :703-706)."""
    r = np.random.RandomState(7)
    n = 512
    px, py = r.randint(0, 800, n), r.randint(0, 600, n)
    vi, s = r.randint(0, 7, n), r.randint(0, 8, n)
    db = r.randint(0, 4, n)
    ld = tier == "ld"
    jg = JR.make(jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32),
                 jnp.asarray(vi, jnp.uint32),
                 jnp.uint32(5) + jnp.asarray(s, jnp.uint32), hq=tier == "hq")
    jg = JR.start_effect(jg, JR.EFFECT_SCATTER_BSDF,
                         jnp.asarray(db < 2) if ld else False)
    jg, ju = JR.next_3d(jg)
    t = lambda a: torch.as_tensor(a.astype(np.int64))
    path = TI.PathState(*([None] * 15), px=t(px), py=t(py))
    tg = TI._sample_gen(reference_config(rng_quality=tier), path, t(vi), 5,
                        t(s).to(torch.int32))
    tg = TR.start_effect(tg, TR.EFFECT_SCATTER_BSDF,
                         t(db) < 2 if ld else False)
    tg, tu = TR.next_3d(tg)
    assert np.array_equal(np.asarray(ju), tu.numpy())


def test_fill_chain_matches_reference(monkeypatch):
    """The realtime FILL pass through the chain (shade_megakernel=False):
    one frame of the ref-vs-realtime pipeline (no ReSTIR, denoiser or
    TAA), against the reference's frame with its XLA chain."""
    from rtxpt_tpu.models.realtime import RealtimeRenderer as JRealtime
    from rtxpt_tpu.models.renderer import realtime_config as j_config
    from rtxpt_tpu.scene import envmap as JEM
    from rtxpt_tpu.scene import procedural as JP
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import realtime_config

    cfg = dict(use_restir_di=False, use_restir_gi=False,
               denoiser_enabled=False, realtime_noise=False,
               use_stable_planes=True, max_bounces=3,
               nee_distant_samples=1, nee_local_samples=1,
               enable_russian_roulette=False, shade_megakernel=False)
    reference_env(monkeypatch)
    jr = JRealtime(JP.build_programmer_art().finish(), JP.default_camera(W, H),
                   j_config(**cfg),
                   env_radiance=JEM.bake_procedural_sky(height=32))
    ref = np.asarray(jr.render_frame(W, H, denoise=False, taa=False))
    r = RealtimeRenderer(TP.build_programmer_art().finish(),
                         TP.default_camera(W, H), realtime_config(**cfg),
                         env_radiance=TEM.bake_procedural_sky(height=32),
                         device="cpu")
    steps = []
    chain = TI._chain_shade_step
    monkeypatch.setattr(TI, "_chain_shade_step",
                        lambda *a, **k: steps.append(1) or chain(*a, **k))
    monkeypatch.setattr(TI, "_shade_step", None)   # the fused pass: unused
    got = r.render_frame(W, H, denoise=False, taa=False).numpy()
    assert steps
    assert np.isfinite(got).all() and got.mean() > 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
