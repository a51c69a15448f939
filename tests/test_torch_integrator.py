"""The whole slice: the port's Renderer against the reference's Renderer on
the CPU, programmer-art at 16x12, 3 bounces, NEE 2+2 (reference_config),
1 spp (plain bounce loop) and 2 spp (path regeneration).

The reference runs its dense trace and shade megakernel in interpret mode
(its CPU default would take the BVH and XLA-chain paths), so both sides
evaluate the same algorithm on the same tables and RNG streams. Tolerance
rtol 2e-4 / atol 5e-5 on the HDR image: the reference selects closest
hits on a t with the low mantissa bits dropped (the port selects
exactly), and XLA and PyTorch round sin/cos/sqrt-heavy shading a few ulps
apart; both only re-associate float error, no lane may take another
path."""
import numpy as np
import pytest
import torch

from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import reference_config as j_reference_config
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.config import default_constants
from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.pt import integrator as TI
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import procedural as TP

W, H = 16, 12


def _reference(monkeypatch):
    monkeypatch.setenv("RTXPT_SHADE_KERNEL", "1")
    monkeypatch.setenv("RTXPT_SHADE_KERNEL_INTERPRET", "1")
    monkeypatch.setenv("RTXPT_DENSE_INTERPRET", "1")
    return JRenderer(JP.build_programmer_art().finish(),
                     JP.default_camera(W, H),
                     j_reference_config(max_bounces=3),
                     env_radiance=JEM.bake_procedural_sky(height=32))


def _port():
    return Renderer(TP.build_programmer_art().finish(),
                    TP.default_camera(W, H), reference_config(max_bounces=3),
                    env_radiance=TEM.bake_procedural_sky(height=32),
                    device="cpu")


@pytest.mark.parametrize("spp", [1, 2])
def test_renderer_matches_reference(monkeypatch, spp):
    """The port's own build, and the port running on the reference's
    tables (interop), both against the reference's image."""
    jr = _reference(monkeypatch)
    ref = np.asarray(jr.render(W, H, spp))
    got = _port().render(W, H, spp).numpy()
    assert got.shape == ref.shape == (H, W, 3)
    assert np.isfinite(got).all() and got.mean() > 0.0
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=5e-5)
    shared = _port()
    shared.assets = interop.assets_from_reference(jr.scene, jr.dense,
                                                  jr.env, jr.lights,
                                                  device="cpu")
    same_tables = shared.render(W, H, spp).numpy()
    np.testing.assert_allclose(same_tables, ref, rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(same_tables, got, rtol=1e-5, atol=1e-6)


def test_accumulation_checkpoint_resume(tmp_path):
    """render(2) == render(1) + checkpoint + resume + render(1)."""
    a = _port()
    a.render(W, H, 1)
    full = a.render(W, H, 1).clone()
    b = _port()
    b.render(W, H, 1)
    path = str(tmp_path / "ckpt.npz")
    b.save_checkpoint(path)
    c = _port()
    assert c.load_checkpoint(path) and c.sample_index == 1
    assert torch.equal(c.render(W, H, 1), full)


def test_ray_counts():
    """render_wavefront_counted counts the closest-hit rays of every
    bounce (at least one per pixel) and the NEE visibility rays."""
    r = _port()
    px, py = r._pixel_grid(W, H)
    cam = r._camera(W, H, (0.0, 0.0))
    rad, rays = TI.render_wavefront_counted(
        r.assets, cam, px, py, default_constants(0), cfg=r.cfg)
    assert rays[0].item() >= W * H and rays[1].item() > 0
    assert rad.shape == (W * H, 3) and torch.isfinite(rad).all()


@pytest.mark.parametrize("spp", [1, 2])
def test_width_compaction_is_exact(spp):
    """Tail compaction (1 spp) and staged regen compaction (2 spp) of a
    16384-lane wavefront merge back to the image of the uncompacted loop,
    bit for bit: lanes are independent and keep their order."""
    import dataclasses
    w, h = 128, 128
    cam = TP.default_camera(w, h)
    host = TP.build_programmer_art().finish()
    env = TEM.bake_procedural_sky(height=32)
    cfg = reference_config(max_bounces=3, nee_distant_samples=1,
                           nee_local_samples=1)
    assert w * h >= cfg.wavefront_compaction_min
    on = Renderer(host, cam, cfg, env_radiance=env,
                  device="cpu").render(w, h, spp)
    off = Renderer(host, cam, dataclasses.replace(
        cfg, wavefront_compaction=False), env_radiance=env,
        device="cpu").render(w, h, spp)
    assert torch.equal(on, off)
