"""The realtime slice as a whole: the port's RealtimeRenderer against the
reference's on the CPU, programmer-art at 16x12 with max_bounces=3,
frames 1 (no history) and 2 (temporal reuse, denoiser and TAA history).

Two pipelines: the default one (3 stable planes, ReSTIR DI + GI, ReLAX,
TAA, NEE 2+2) and the `ref-vs-realtime` preset (no ReSTIR, denoiser or
TAA, NEE 1+1, no Russian roulette, no jitter). The reference runs its
dense trace and shade megakernel in interpret mode, as its own CPU tests
do. The port runs on its own build and on the reference's tables
(interop).

Tolerance on the HDR frame: rtol 2e-4 / atol 5e-5, as the reference-mode
slice (tests/test_torch_integrator.py): the reference's dense trace drops
low mantissa bits of t when it picks a winner, and XLA and PyTorch round
the shading a few ulps apart. A reservoir whose choice flips on such a
difference changes its pixel and, through spatial reuse, ReLAX and TAA,
the pixels within REACH of it, in this frame and (through the
histories) the next: the flipped DI and GI reservoirs are counted and
their share bounded (2%), and every pixel outside their reach is held to
the tolerance. On these seeded inputs no reservoir flips in either
pipeline, so every pixel of both frames is held."""
import numpy as np
import pytest
import torch

from rtxpt_tpu.models.realtime import RealtimeRenderer as JRealtime
from rtxpt_tpu.models.renderer import realtime_config as j_realtime_config
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
from rtxpt_tpu_torch.models.renderer import realtime_config
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.parallel import meshutils
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import procedural as TP

W, H = 16, 12
FRAMES = 2
# how far a flipped reservoir reaches within one frame, in pixels (square
# radius): DI spatial reuse (radius 20, restir/di.py), the ReLAX temporal
# clamp box and bilinear reprojection (2), its variance box (3), four
# a-trous passes of 5x5 taps at steps 1-8 (30), TAA's clamp box and
# Catmull-Rom history fetch (3)
REACH = 20 + 2 + 3 + 30 + 3
PIPELINES = {
    "default": dict(cfg=dict(use_restir_di=True, use_restir_gi=True,
                             denoiser_enabled=True, use_stable_planes=True,
                             max_bounces=3),
                    frame=dict()),
    "ref-vs-realtime": dict(cfg=dict(use_restir_di=False,
                                     use_restir_gi=False,
                                     denoiser_enabled=False,
                                     realtime_noise=False,
                                     use_stable_planes=True, max_bounces=3,
                                     nee_distant_samples=1,
                                     nee_local_samples=1,
                                     enable_russian_roulette=False),
                            frame=dict(denoise=False, taa=False)),
}


def _reach(seed):
    """(H, W) pixels within REACH of any pixel of `seed`."""
    ys, xs = np.nonzero(seed)
    yy, xx = np.mgrid[:H, :W]
    return ((np.abs(yy[..., None] - ys) <= REACH)
            & (np.abs(xx[..., None] - xs) <= REACH)).any(-1)


def _state(r):
    """What one frame hands the next: the DI and GI feedback reservoirs,
    as numpy."""
    return {"light": np.asarray(r.prev_reservoir.light),
            "gi_pos": np.asarray(r.prev_gi.pos),
            "gi_valid": np.asarray(r.prev_gi.valid)}


@pytest.fixture(scope="module", params=sorted(PIPELINES))
def reference(request):
    """(pipeline name, reference renderer, its frames and states)."""
    p = PIPELINES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTXPT_SHADE_KERNEL", "1")
        mp.setenv("RTXPT_SHADE_KERNEL_INTERPRET", "1")
        mp.setenv("RTXPT_DENSE_INTERPRET", "1")
        jr = JRealtime(JP.build_programmer_art().finish(),
                       JP.default_camera(W, H),
                       j_realtime_config(**p["cfg"]),
                       env_radiance=JEM.bake_procedural_sky(height=32))
        frames = []
        for _ in range(FRAMES):
            img = np.asarray(jr.render_frame(W, H, **p["frame"]))
            frames.append((img, _state(jr)))
    return request.param, jr, frames


@pytest.mark.parametrize("tables", ["own", "shared"])
def test_realtime_frames_match_reference(reference, tables,
                                        record_property):
    name, jr, frames = reference
    p = PIPELINES[name]
    r = RealtimeRenderer(TP.build_programmer_art().finish(),
                         TP.default_camera(W, H), realtime_config(**p["cfg"]),
                         env_radiance=TEM.bake_procedural_sky(height=32),
                         device="cpu")
    if tables == "shared":
        r.assets = interop.assets_from_reference(jr.scene, jr.dense, jr.env,
                                                 jr.lights, device="cpu")
    cuda_lib.reset_launch_counts()
    reached = np.zeros((H, W), dtype=bool)
    for i, (ref, ref_state) in enumerate(frames):
        got = r.render_frame(W, H, **p["frame"]).numpy()
        assert got.shape == ref.shape == (H, W, 3)
        assert np.isfinite(got).all() and got.mean() > 0.0
        state = _state(r)
        flipped = (state["light"] != ref_state["light"]) | (
            state["gi_valid"] != ref_state["gi_valid"]) | ~np.isclose(
                state["gi_pos"], ref_state["gi_pos"], rtol=1e-4,
                atol=1e-4).all(-1)
        assert flipped.mean() <= 0.02, (i, flipped.sum())
        record_property(f"flipped_frame{i + 1}", int(flipped.sum()))
        # a flip in an earlier frame reaches this one through the histories
        reached = _reach(flipped.reshape(H, W) | reached)
        held = ~reached
        np.testing.assert_allclose(got[held], ref[held], rtol=2e-4,
                                   atol=5e-5, err_msg=f"frame {i + 1}, "
                                   f"{int(flipped.sum())} flipped")
    # CPU tensors take the plain versions: no kernel was launched
    assert not any(cuda_lib.launch_counts().values())
    if name == "default":
        # frame 2 reused frame 1's reservoirs and histories
        assert float(r.prev_reservoir.m.max()) > 8.0
        assert r.taa_state.valid
        assert float(r.den_states[0][0].history.max()) >= 2.0


@pytest.mark.parametrize("what", ["mesh"])
def test_unported_options_raise(what):
    """What a multi-device mesh does not carry (ReBLUR on more than one
    rank: the reference's sharded post runs ReLAX whatever the method)
    refuses to run instead of rendering something else."""
    host, cam = TP.build_programmer_art().finish(), TP.default_camera(8, 6)
    env = TEM.bake_procedural_sky(height=16)
    kw = dict(use_restir_di=True, use_restir_gi=True, denoiser_enabled=True,
              use_stable_planes=True, max_bounces=1,
              denoiser_method="reblur")
    mesh = meshutils.Mesh(group=None, rank=0, size=2,
                          device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="ReLAX only"):
        RealtimeRenderer(host, cam, realtime_config(**kw), mesh=mesh,
                         env_radiance=env, device="cpu")
