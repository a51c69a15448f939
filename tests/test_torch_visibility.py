"""Visibility rays with the exact alpha test (rtxpt_tpu_torch/pt/
visibility.py) against the reference's on tests/test_visibility.py's
scenes: an alpha-MASK occluder of sub-cell stripes or sparse dots over a
floor. The exact re-queue and the plain masked any-hit trace give the
reference's occlusion lane for lane, and the exact one stays within the
brute-force alpha oracle; `sample_opacity` equals the reference's; the
Renderer clears exact_alpha_test for scenes without MASK materials, and
on the textured scene of tests/textured_scene.py the masks alone
(exact_alpha_test=False) give another image than the exact test."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import textured_scene as TS
from reference_configs import reference_env
from test_visibility import _host, _oracle_occlusion, _rays
from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import reference_config as j_config
from rtxpt_tpu.pt import visibility as JVIS
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.pt import visibility as TVIS
from rtxpt_tpu_torch.scene import camera as TC
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import procedural as TP
from rtxpt_tpu_torch.scene.build import Mesh, SceneBuilder


def _image(pattern):
    img = np.full((32, 32, 4), 255, np.uint8)
    if pattern == "stripes":
        img[:, ::2, 3] = 0                 # sub-cell stripes
    else:
        img[..., 3] = 0
        img[::4, ::4, 3] = 255             # sparse opaque dots
    return img


@pytest.fixture(scope="module", params=["stripes", "sparse_dots"])
def pair(request):
    """(pattern, reference Renderer, port Renderer) of one scene."""
    img = _image(request.param)
    with pytest.MonkeyPatch.context() as mp:
        reference_env(mp)
        jr = JRenderer(_host(img), JP.default_camera(8, 8),
                       j_config())
    r = Renderer(_host(img), TP.default_camera(8, 8), reference_config(),
                 device="cpu")
    return request.param, img, jr, r


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "masks"])
def test_visibility_matches_reference(pair, monkeypatch, exact):
    pattern, img, jr, r = pair
    assert r.cfg.exact_alpha_test and jr.cfg.exact_alpha_test
    reference_env(monkeypatch)
    o, d = _rays()
    ref = np.asarray(JVIS.trace_visibility(jr.assets, o, d, t_max=10.0,
                                           exact=exact))
    stats = {}
    got = TVIS.trace_visibility(r.assets, torch.tensor(np.asarray(o)),
                                torch.tensor(np.asarray(d)), t_max=10.0,
                                exact=exact, stats=stats).numpy()
    assert np.array_equal(got, ref)
    oracle = _oracle_occlusion(img, o)
    if exact:
        assert (got == oracle).mean() > 0.97
        assert abs(got.mean() - oracle.mean()) < 0.05
        assert stats["requeued"] > 0 and stats["unresolved"] == 0
    else:
        # a set mask bit counts as an occluder: the masks over-darken
        assert got.mean() > oracle.mean() + 0.05 and not stats


def test_sample_opacity_matches_reference(pair):
    _, _, jr, r = pair
    rs = np.random.RandomState(0)
    prim = rs.randint(-1, 4, 300).astype(np.int32)
    bary = rs.uniform(0, 0.5, (300, 2)).astype(np.float32)
    ref = JVIS.sample_opacity(jr.scene, jnp.asarray(prim), jnp.asarray(bary))
    got = TVIS.sample_opacity(r.scene, torch.as_tensor(prim),
                              torch.as_tensor(bary))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_exact_alpha_cleared_without_mask_materials():
    host = TP.build_programmer_art().finish()
    r = Renderer(host, TP.default_camera(8, 8), reference_config(),
                 device="cpu")
    assert not r.cfg.exact_alpha_test
    host = TS.build(SceneBuilder, Mesh)
    host.pop("texture_images")
    r = Renderer(host, TS.camera(TC, 8, 8), reference_config(), device="cpu")
    assert not r.cfg.exact_alpha_test


def test_masks_alone_change_the_textured_image():
    host = TS.build(SceneBuilder, Mesh)
    env = TEM.bake_procedural_sky(height=32)
    means = {}
    for exact in (True, False):
        cfg = dataclasses.replace(reference_config(max_bounces=3),
                                  exact_alpha_test=exact)
        r = Renderer(host, TS.camera(TC), cfg, env_radiance=env,
                     device="cpu")
        means[exact] = float(r.render(TS.W, TS.H, 2).mean())
    assert means[True] != means[False], means
