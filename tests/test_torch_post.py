"""The realtime mode's post stages (rtxpt_tpu_torch/post/taau.py,
post/tonemap.py, denoise/offline.py) against the reference package on the
CPU, on seeded inputs.

TAAU over 8 jittered frames (R2 jitter, sub-pixel motion): frame 1
starts the history; each later frame takes the reference's state,
converted by `interop`, so every frame is held on identical inputs
(rtol 1e-5 / atol 1e-6: float32 stencils in the same order; the clip's
sqrt of a variance near 0 makes this the tightest tolerance that is
not bit equality). The tone mapper: every operator, white balance at
3000, 6500 and 10000 K and eye adaptation (rtol 1e-5 / atol 1e-6); the
default call (ACES, no white balance, no adaptation) bit-identical to the
expression the port evaluated before the operators existed. The
photo-mode denoiser on seeded guides (rtol 1e-5 / atol 1e-6), and
`photo_denoise_auto` on a
programmer-art render with the G-buffer traced on the reference's tables
(the dense trace in interpret mode) at the realtime tolerance (rtol 2e-4
/ atol 5e-5). Then tests/test_post.py's two properties on the port."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.denoise import offline as JOFF
from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import realtime_config as j_realtime_config
from rtxpt_tpu.post import taau as JTAAU
from rtxpt_tpu.post import tonemap as JTM
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.denoise import offline as TOFF
from rtxpt_tpu_torch.denoise import relax as TRX
from rtxpt_tpu_torch.models.renderer import Renderer, r2_jitter
from rtxpt_tpu_torch.models.renderer import realtime_config
from rtxpt_tpu_torch.post import taau as TTAAU
from rtxpt_tpu_torch.post import tonemap as TTM
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import procedural as TP

RTOL, ATOL = 1e-5, 1e-6
HR, WR = 12, 16            # TAAU render size
DISPLAY = (40, 30)         # TAAU display size (Wd, Hd), 2.5x


def _close(got, ref, msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _hdr(seed, h=24, w=32):
    rs = np.random.RandomState(seed)
    return (rs.gamma(0.8, 1.5, (h, w, 3))
            * rs.choice([0.01, 1.0, 30.0], (h, w, 1))).astype(np.float32)


def test_taau_resolve_eight_frames():
    j_state = t_state = None
    for i in range(8):
        rs = np.random.RandomState(100 + i)
        color = rs.gamma(1.0, 1.0, (HR, WR, 3)).astype(np.float32)
        motion = rs.uniform(-1.2, 1.2, (HR, WR, 2)).astype(np.float32)
        jit = r2_jitter(i)
        ref, j_new = JTAAU.resolve(j_state, jnp.asarray(color),
                                   jnp.asarray(motion), DISPLAY,
                                   jitter=jnp.asarray(jit, jnp.float32))
        got, t_new = TTAAU.resolve(t_state, torch.as_tensor(color),
                                   torch.as_tensor(motion), DISPLAY,
                                   jitter=jit)
        assert got.shape == (DISPLAY[1], DISPLAY[0], 3)
        _close(got, ref, f"frame {i + 1}")
        _close(t_new.history, j_new.history, "history")
        assert t_new.valid == bool(j_new.valid)
        j_state = j_new
        t_state = interop.taau_state_from_reference(j_state, "cpu")


@pytest.mark.parametrize("op", [TTM.OP_LINEAR, TTM.OP_REINHARD, TTM.OP_ACES,
                                TTM.OP_HABLE_UC2, TTM.OP_CLAMP],
                         ids=["linear", "reinhard", "aces", "hable-uc2",
                              "clamp"])
@pytest.mark.parametrize("auto", [False, True], ids=["fixed", "auto"])
def test_tonemap_operators_match_reference(op, auto):
    hdr = _hdr(1)
    assert (op == TTM.OP_ACES) == (op == JTM.OP_ACES)
    ref = JTM.tonemap(jnp.asarray(hdr), exposure=0.7, operator=op,
                      auto_expose=auto)
    got = TTM.tonemap(torch.as_tensor(hdr), exposure=0.7, operator=op,
                      auto_expose=auto)
    _close(got, ref, f"operator {op}")
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("kelvin", [3000.0, 6500.0, 10000.0])
def test_white_balance_matches_reference(kelvin):
    np.testing.assert_array_equal(TTM.white_balance_scale(kelvin).numpy(),
                                  np.asarray(JTM.white_balance_scale(kelvin)))
    hdr = _hdr(2)
    ref = JTM.tonemap(jnp.asarray(hdr), white_balance_k=kelvin)
    got = TTM.tonemap(torch.as_tensor(hdr), white_balance_k=kelvin)
    _close(got, ref, f"{kelvin} K")
    if kelvin == 3000.0:
        # a warm illuminant is neutralized toward blue
        scale = TTM.white_balance_scale(kelvin)
        assert float(scale[2]) > float(scale[0])


def test_eye_adaptation_matches_reference():
    """Four frames of exponential adaptation toward each frame's
    auto-exposure; the call returns (srgb, exposure)."""
    j_exp = t_exp = 1.0
    for i in range(4):
        hdr = _hdr(10 + i) * (0.1 if i % 2 else 10.0)
        ref, j_exp = JTM.tonemap(jnp.asarray(hdr), auto_expose=True,
                                 prev_exposure=jnp.asarray(j_exp,
                                                           jnp.float32),
                                 adaptation_rate=0.25)
        got, t_exp = TTM.tonemap(torch.as_tensor(hdr), auto_expose=True,
                                 prev_exposure=torch.as_tensor(t_exp),
                                 adaptation_rate=0.25)
        _close(got, ref, f"frame {i + 1}")
        _close(t_exp, j_exp, "exposure")
    # without a rate the exposure is this frame's own
    hdr = torch.as_tensor(_hdr(20))
    _, e = TTM.tonemap(hdr, auto_expose=True, prev_exposure=torch.tensor(9.0))
    assert float(e) == float(TTM.auto_exposure(hdr))


@pytest.mark.parametrize("auto", [False, True], ids=["fixed", "auto"])
def test_tonemap_default_is_unchanged(auto):
    """The default call is bit for bit the ACES-only tone map the port had
    before the operators (the goldens read it)."""
    hdr = torch.as_tensor(_hdr(3))
    scale = torch.tensor(1.3, dtype=torch.float32)
    if auto:
        scale = scale * TTM.auto_exposure(hdr)
    before = TTM.linear_to_srgb(TTM.aces_fitted(torch.clamp(hdr, min=0.0)
                                                * scale))
    got = TTM.tonemap(hdr, exposure=1.3, auto_expose=auto)
    np.testing.assert_array_equal(got.numpy(), before.numpy())


def test_photo_denoise_matches_reference():
    rs = np.random.RandomState(5)
    h, w = 24, 32
    hdr = _hdr(4, h, w)
    albedo = rs.uniform(0.05, 0.9, (h, w, 3)).astype(np.float32)
    nrm = rs.normal(size=(h, w, 3)) + np.array([0.0, 0.0, 4.0])
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    z = (3.0 + (np.arange(w)[None, :] > w // 2) * 2.0
         + 0.01 * rs.normal(size=(h, w))).astype(np.float32)
    ref = JOFF.photo_denoise(jnp.asarray(hdr), jnp.asarray(albedo),
                             jnp.asarray(nrm), jnp.asarray(z))
    got = TOFF.photo_denoise(torch.as_tensor(hdr), torch.as_tensor(albedo),
                             torch.as_tensor(nrm), torch.as_tensor(z))
    _close(got, ref, "photo_denoise")


def test_photo_denoise_auto_matches_reference():
    """photo_denoise_auto on an 8-spp 48x32 render (the port's, fed to
    both): the G-buffer guides traced on the reference's tables."""
    w, h = 48, 32
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTXPT_DENSE_INTERPRET", "1")
        jr = JRenderer(JP.build_programmer_art().finish(),
                       JP.default_camera(w, h), j_realtime_config(),
                       env_radiance=JEM.bake_procedural_sky(height=32))
        r = Renderer(TP.build_programmer_art().finish(),
                     TP.default_camera(w, h), realtime_config(max_bounces=3),
                     env_radiance=TEM.bake_procedural_sky(height=32),
                     device="cpu")
        r.assets = interop.assets_from_reference(jr.scene, jr.dense, jr.env,
                                                 jr.lights, device="cpu")
        hdr = r.render(w, h, 8)
        ref = JOFF.photo_denoise_auto(jr, jnp.asarray(hdr.numpy()), w, h)
    got = TOFF.photo_denoise_auto(r, hdr, w, h)
    assert got.shape == (h, w, 3) and np.isfinite(got.numpy()).all()
    _close(got, ref, "photo_denoise_auto", rtol=2e-4, atol=5e-5)
    # the filter lowers the noise of the 8-spp render
    assert float(torch.abs(got[1:] - got[:-1]).mean()) < float(
        torch.abs(hdr[1:] - hdr[:-1]).mean())


# ---- tests/test_post.py's properties on the port

FREQ = 12.0   # cycles across width: half the render Nyquist rate


def _render_pattern(hr, wr, jitter):
    """A horizontal sinusoid point-sampled at render size with the camera
    jitter applied (detail the R2 jitter sequence can recover)."""
    xx = np.mgrid[0:hr, 0:wr][1]
    u = (xx + 0.5 + jitter[0]) / wr
    img = (0.5 + 0.5 * np.sin(2 * np.pi * FREQ * u)).astype(np.float32)
    return torch.as_tensor(np.repeat(img[..., None], 3, axis=-1))


def test_taau_upscales_and_converges():
    hr, wr, hd, wd = 36, 48, 72, 96
    state = out = None
    for i in range(32):
        jit = r2_jitter(i)
        out, state = TTAAU.resolve(state, _render_pattern(hr, wr, jit),
                                   torch.zeros((hr, wr, 2)), (wd, hd),
                                   jitter=jit)
    assert out.shape == (hd, wd, 3)
    o = out.numpy()
    assert np.isfinite(o).all()
    xxd = (np.arange(wd) + 0.5) / wd
    truth = np.repeat((0.5 + 0.5 * np.sin(2 * np.pi * FREQ * xxd))
                      .astype(np.float32)[None, :], hd, 0)
    single, _ = TTAAU.resolve(None, _render_pattern(hr, wr, (0.3, 0.1)),
                              torch.zeros((hr, wr, 2)), (wd, hd),
                              jitter=(0.3, 0.1))
    mae_taau = np.abs(o[..., 0] - truth).mean()
    mae_single = np.abs(single.numpy()[..., 0] - truth).mean()
    assert mae_taau < mae_single / 1.1, (mae_taau, mae_single)


def test_history_clamp_kills_ghosts():
    """A bright ghost in ReLAX's history is clamped toward the current
    frame's neighbourhood and its history length cut."""
    h, w = 32, 32
    dark = torch.full((h, w, 3), 0.1)
    nrm = torch.tensor([0.0, 1.0, 0.0]).expand(h, w, 3)
    z = torch.ones((h, w))
    ghost = dark.clone()
    ghost[10:16, 10:16] = 25.0
    state = TRX.DenoiserState(radiance=ghost, moments=torch.zeros((h, w, 2)),
                              history=torch.full((h, w), 16.0), normal=nrm,
                              view_z=z)
    out, new_state = TRX.denoise(state, dark, nrm, z,
                                 torch.zeros((h, w, 2)), iterations=1)
    assert float(out[12, 12].max()) < 1.0
    assert float(new_state.history[12, 12]) < 16.0
