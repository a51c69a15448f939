"""ReBLUR (rtxpt_tpu_torch/denoise/reblur.py) against the reference
package on the CPU.

`reblur.denoise` over 3 frames on seeded inputs: noisy radiance, a normal
field with a crease, a depth step, sub-pixel motion, a hit-distance field
and, on the specular channel, roughness. Frame 1 starts without history;
each later frame takes the reference's state, converted by `interop`, so
every frame is held on identical inputs. The stencils are float32 in the
same order in both packages, but XLA's and PyTorch's pow and exp round
a few ulps apart in the blur weights (a normal power up to 1024 on the
specular channel), and the later passes, the history fix and the
stabilization clamp carry that on: about 3e-5 relative on these inputs,
so the tolerance is rtol 1e-4 / atol 1e-5 (frame 1, without history,
agrees within 5e-7).

ReBLUR frames of the stable-planes pipeline (3 planes, ReSTIR DI + GI,
NEE 2+2; the hit-distance channel of each plane drives the radius) at
16x12: frames 1 and 2 with the reach-masked comparison of
tests/realtime_compare.py. Frame 1 is the one `render_frame(display_size=)`
of the slice: TAAU upscales it to 32x24 in TAA's place (a first TAAU
frame is the jitter-corrected bilinear fetch); frame 2 takes TAA.
TAAU's history is held over 8 jittered frames in tests/test_torch_post.py,
on identical inputs: its variance clip, sqrt(E[x^2] - E[x]^2) of a flat
neighbourhood, turns ulp differences of a whole frame into ~1e-3. The PSR-lite pipeline's ReBLUR frames are in
tests/test_torch_psr_restir.py. Then tests/test_reblur.py's properties on
the port."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_compare import (compare_frames, port_renderer,
                              reference_frames)
from rtxpt_tpu.denoise import reblur as JRB
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.denoise import reblur as TRB
from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
from rtxpt_tpu_torch.models.renderer import realtime_config
from rtxpt_tpu_torch.post import taa as TTAA
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import procedural as TP

H, W = 20, 28
RTOL, ATOL = 1e-4, 1e-5
STABLE = dict(use_restir_di=True, use_restir_gi=True, denoiser_enabled=True,
              use_stable_planes=True, denoiser_method="reblur",
              max_bounces=3)
FRAME_KW = [dict(display_size=(32, 24)), dict()]


def _frame(seed):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    rad = (rs.gamma(1.0, 1.0, (H, W, 3))
           * (1.0 + (xx > W / 2))[..., None]).astype(np.float32)
    nrm = np.stack([np.where(xx > W / 3, 0.6, 0.0), 0.1 * np.sin(yy),
                    np.ones_like(xx)], -1)
    nrm = nrm + 0.02 * rs.normal(size=nrm.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)) \
        .astype(np.float32)
    z = (4.0 + 0.05 * yy + np.where(yy > H / 2, 3.0, 0.0)).astype(np.float32)
    motion = rs.uniform(-1.5, 1.5, (H, W, 2)).astype(np.float32)
    rough = rs.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    hit_t = rs.uniform(0.05, 20.0, (H, W)).astype(np.float32)
    return rad, nrm, z, motion, rough, hit_t


@pytest.mark.parametrize("channel", ["diffuse", "specular"])
def test_reblur_denoise_three_frames(channel):
    """Diffuse: 2 blur passes, no roughness; specular: 3 with roughness
    (the realtime pipelines' two channels)."""
    j_state = None
    t_state = None
    for frame in range(3):
        rad, nrm, z, motion, rough, hit_t = _frame(frame)
        kw = dict(iterations=2) if channel == "diffuse" else dict(
            iterations=3)
        ref, j_state_new = JRB.denoise(
            j_state, jnp.asarray(rad), jnp.asarray(nrm), jnp.asarray(z),
            jnp.asarray(motion), hit_t=jnp.asarray(hit_t),
            roughness=None if channel == "diffuse" else jnp.asarray(rough),
            **kw)
        t = lambda a: torch.as_tensor(a)
        got, t_state_new = TRB.denoise(
            t_state, t(rad), t(nrm), t(z), t(motion), hit_t=t(hit_t),
            roughness=None if channel == "diffuse" else t(rough), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL, err_msg=f"frame {frame + 1}")
        for name, val in t_state_new._asdict().items():
            want = np.asarray(getattr(j_state_new, name))
            if name == "stab_valid":
                assert val == bool(want)
            else:
                np.testing.assert_allclose(val.numpy(), want, rtol=RTOL,
                                           atol=ATOL, err_msg=name)
        j_state = j_state_new
        t_state = interop.reblur_state_from_reference(j_state, device="cpu")
    assert t_state.stab_valid and float(t_state.history.max()) >= 3.0


def test_reblur_stages_match_reference():
    """The stages on their own: the accumulation without history, the
    anti-firefly clamp and one blur pass at a per-pixel radius."""
    rad, nrm, z, motion, rough, hit_t = _frame(7)
    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.as_tensor(a)
    ref = JRB._accumulate(JRB.ReblurState.create(H, W), j(rad), j(hit_t),
                          j(nrm), j(z), j(motion))
    got = TRB._accumulate(TRB.ReblurState.create(H, W, "cpu"), t(rad),
                          t(hit_t), t(nrm), t(z), t(motion))
    for name in ("radiance", "fast", "hit_t", "history"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(TRB._anti_firefly(t(rad)).numpy(),
                               np.asarray(JRB._anti_firefly(j(rad))),
                               rtol=RTOL, atol=ATOL)
    radius = 8.0 * hit_t / (hit_t + z)
    np.testing.assert_allclose(
        TRB._blur_pass(t(rad), t(radius), t(nrm), t(z), t(rough),
                       1.3).numpy(),
        np.asarray(JRB._blur_pass(j(rad), j(radius), j(nrm), j(z), j(rough),
                                  1.3)), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def reference():
    return reference_frames(STABLE, FRAME_KW)


@pytest.mark.parametrize("tables", ["own", "shared"])
def test_reblur_frames_match_reference(reference, tables,
                                            record_property):
    jr, frames = reference
    r = port_renderer(jr, STABLE, tables)
    out = compare_frames(r, frames, FRAME_KW, record_property)
    assert out[0].shape == (24, 32, 3) and out[1].shape == (12, 16, 3)
    # ReBLUR states on every plane, with the two frames' history
    assert all(isinstance(d, TRB.ReblurState) and isinstance(s,
               TRB.ReblurState) for d, s in r.den_states)
    assert float(r.den_states[0][0].history.max()) >= 2.0
    # TAAU ran in frame 1 (its history is the display frame), TAA in 2
    assert r.taau_state.valid and r.taa_state.valid
    np.testing.assert_array_equal(r.taau_state.history.numpy(), out[0])


# ---- tests/test_reblur.py's properties on the port


def _noisy(h, w, seed, base=1.0, sigma=0.5):
    r = np.random.RandomState(seed)
    return torch.as_tensor((base + sigma * r.randn(h, w, 3))
                           .astype(np.float32))


def _flat_geo(h, w):
    normal = torch.tensor([0.0, 0.0, 1.0]).expand(h, w, 3)
    return normal, torch.full((h, w), 5.0), torch.zeros((h, w, 2))


def test_reblur_reduces_noise_and_converges():
    h, w = 48, 64
    normal, view_z, motion = _flat_geo(h, w)
    state = out = None
    for f in range(6):
        out, state = TRB.denoise(state, _noisy(h, w, f), normal, view_z,
                                 motion, hit_t=torch.full((h, w), 100.0))
    out = out.numpy()[8:-8, 8:-8]
    assert abs(out.mean() - 1.0) < 0.05
    assert out.std() < 0.5 * 0.5


def test_reblur_hit_distance_drives_radius():
    """A short hit distance (contact) blurs less than a long one."""
    h, w = 48, 64
    normal, view_z, motion = _flat_geo(h, w)
    rad = _noisy(h, w, 3)
    far, _ = TRB.denoise(None, rad, normal, view_z, motion,
                         hit_t=torch.full((h, w), 1e4))
    near, _ = TRB.denoise(None, rad, normal, view_z, motion,
                          hit_t=torch.full((h, w), 0.01))
    far_std = float(far.numpy()[8:-8, 8:-8].std())
    near_std = float(near.numpy()[8:-8, 8:-8].std())
    assert far_std < 0.6 * near_std, (far_std, near_std)


def test_reblur_preserves_geometric_edges():
    h, w = 48, 64
    _, view_z, motion = _flat_geo(h, w)
    nl = np.broadcast_to([0.0, 0.0, 1.0], (h, w // 2, 3))
    nr = np.broadcast_to([1.0, 0.0, 0.0], (h, w - w // 2, 3))
    normal = torch.as_tensor(np.concatenate([nl, nr], axis=1)
                             .astype(np.float32))
    rad = np.ones((h, w, 3), np.float32)
    rad[:, w // 2:] = 3.0
    out, _ = TRB.denoise(None, torch.as_tensor(rad), normal, view_z, motion,
                         hit_t=torch.full((h, w), 1e4))
    out = out.numpy()
    assert abs(out[:, :w // 2 - 2].mean() - 1.0) < 0.05
    assert abs(out[:, w // 2 + 2:].mean() - 3.0) < 0.05


def test_taa_relax_mask_skips_stale_history():
    """Where the denoiser's history reset relaxes TAA fully, the output is
    the current frame; without it the ghost history shows."""
    h, w = 16, 16
    rs = np.random.RandomState(0)
    color = torch.as_tensor((1.0 + 0.6 * rs.randn(h, w, 3))
                            .astype(np.float32))
    state = TTAA.TAAState(history=torch.full((h, w, 3), 1.4), valid=True)
    motion = torch.zeros((h, w, 2))
    out_rel, _ = TTAA.resolve(state, color, motion,
                              relax_mask=torch.ones((h, w)))
    assert np.allclose(out_rel.numpy(), color.numpy())
    out_def, _ = TTAA.resolve(state, color, motion)
    assert not np.allclose(out_def.numpy(), color.numpy())


@pytest.mark.parametrize("stable", [False, True], ids=["psr-lite",
                                                       "stable-planes"])
def test_denoiser_method_config_selects_reblur(stable):
    """denoiser_method="reblur" renders through ReBLUR on either
    pipeline; an unknown method is refused."""
    host = TP.build_programmer_art().finish()
    cam = TP.default_camera(32, 24)
    cfg = realtime_config(use_restir_di=False, use_restir_gi=False,
                          denoiser_enabled=True, denoiser_method="reblur",
                          use_stable_planes=stable, max_bounces=1,
                          max_diffuse_bounces=1, nee_distant_samples=1,
                          nee_local_samples=0)
    rr = RealtimeRenderer(host, cam, cfg,
                          env_radiance=TEM.bake_procedural_sky(height=32),
                          device="cpu")
    img = rr.render_frame(32, 24).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.0
    den = rr.den_states[0][0] if stable else rr.den_diff
    assert isinstance(den, TRB.ReblurState)
    with pytest.raises(ValueError):
        RealtimeRenderer(host, cam, realtime_config(denoiser_method="nrd"),
                         env_radiance=TEM.bake_procedural_sky(height=16),
                         device="cpu")
