"""The atmospheric sky bake and the directional-light splat
(rtxpt_tpu_torch/scene/envmap.py) against the reference package, and
tests/test_atmosphere.py's five properties on the port.

Both bakes are host float64 numpy in the same order of operations in both
packages and end in one float32 cast, so they must be bit-equal."""
import numpy as np
import pytest
import torch

from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu_torch.scene import envmap as TEM

H = 48


def _sky(**kw):
    return TEM.bake_atmospheric_sky(height=H, samples=16, sun_samples=4,
                                    **kw)


def _dirs():
    v, u = np.meshgrid((np.arange(H) + 0.5) / H,
                       (np.arange(2 * H) + 0.5) / (2 * H), indexing="ij")
    th = v * np.pi
    ph = (u * 2 - 1) * np.pi
    return np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                     np.sin(th) * np.sin(ph)], -1)


@pytest.mark.parametrize("kw", [
    dict(height=16, samples=8, sun_samples=2),
    dict(height=24, sun_dir=(0.999, 0.045, 0.0), turbidity=3.0,
         altitude_m=1500.0, samples=12, sun_samples=3, sky_scale=0.5),
    dict(height=16, sun_dir=(0.999, -0.03, 0.0), sun_angular_radius=0.06,
         ground_albedo=(0.5, 0.4, 0.3), samples=6, sun_samples=2)],
    ids=["default", "low-sun-hazy", "dusk"])
def test_atmospheric_sky_bit_equal(kw):
    got = TEM.bake_atmospheric_sky(**kw)
    ref = np.asarray(JEM.bake_atmospheric_sky(**kw))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_bake_with_directional_bit_equal():
    base = TEM.bake_procedural_sky(height=32)
    lights = [dict(direction=(-0.3, -0.8, 0.2), radiance=(3.0, 2.5, 2.0)),
              dict(direction=(0.5, -0.2, -0.6), radiance=(0.5, 0.5, 1.0))]
    got = TEM.bake_with_directional(base, lights, angular_radius=0.08)
    ref = JEM.bake_with_directional(np.asarray(base), lights,
                                    angular_radius=0.08)
    assert got.dtype == np.float32 and got.shape == base.shape
    np.testing.assert_array_equal(got, ref)
    # each light adds its disc and leaves the base map untouched
    assert (got >= base).all() and (got > base).any()
    assert not np.shares_memory(got, base)


def test_rayleigh_blue_zenith_and_bright_horizon():
    sky = _sky()
    assert np.isfinite(sky).all() and (sky >= 0).all()
    zen = sky[1].mean(0)
    hor = sky[H // 2 - 2].mean(0)
    assert zen[2] > zen[0] * 1.5, zen
    assert hor.mean() > zen.mean(), (hor.mean(), zen.mean())


def test_sunset_reddening():
    d = _dirs()

    def aureole_rb(sky, sun):
        s = np.asarray(sun, float)
        s /= np.linalg.norm(s)
        c = d @ s
        m = (c > np.cos(0.12)) & (c < np.cos(0.02))
        mean = sky[m].mean(0)
        return mean[0] / max(mean[2], 1e-9)

    hi = aureole_rb(_sky(), (0.35, 0.65, 0.2))
    lo = aureole_rb(_sky(sun_dir=(0.999, 0.045, 0.0)), (0.999, 0.045, 0.0))
    assert lo > hi * 1.5, (lo, hi)


def test_earth_shadow_and_sun_disc_hot():
    sky = _sky(sun_angular_radius=0.06)
    d = _dirs()
    up = sky[: H // 2 - 3].mean()
    s = np.asarray((0.35, 0.65, 0.2), float)
    s /= np.linalg.norm(s)
    disc = sky[(d @ s) > np.cos(0.05)].mean()
    assert disc > 50.0 * up, (disc, up)
    dusk = _sky(sun_dir=(0.999, -0.03, 0.0))
    assert dusk[H // 2 + 4:].mean() < 0.05 * sky[H // 2 + 4:].mean()


def test_turbidity_brightens_aureole():
    d = _dirs()
    s = np.asarray((0.35, 0.65, 0.2), float)
    s /= np.linalg.norm(s)
    ring = (d @ s > np.cos(0.25)) & (d @ s < np.cos(0.02))
    assert _sky(turbidity=6.0)[ring].mean() > _sky(turbidity=1.0)[ring].mean()


def test_feeds_importance_pipeline():
    """The baked map builds the port's env tables, and the MIP-descent
    sampler draws finite samples from it."""
    sky = TEM.bake_atmospheric_sky(height=32, samples=8, sun_samples=2)
    env = TEM.make_envmap(sky, device="cpu")
    pyr = TEM.build_mip_pyramid(sky, device="cpu")
    u = torch.as_tensor(np.random.default_rng(0).random((256, 2)),
                        dtype=torch.float32)
    _, pdf, le = TEM.sample_mip_descent(env, pyr, u)
    assert np.isfinite(pdf.numpy()).all() and (pdf.numpy() > 0).any()
    assert np.isfinite(le.numpy()).all()
