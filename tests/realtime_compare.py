"""Helpers of the realtime parity tests: a RealtimeRenderer of the port
against the reference's, frame by frame, on the CPU.

The reference renders with its dense trace and shade megakernel in
interpret mode, as its own CPU tests do. Tolerance on the HDR frame: rtol
2e-4 / atol 5e-5 (tests/test_torch_realtime.py): the reference's dense
trace drops low mantissa bits of t when it picks a winner, and XLA and
PyTorch round the shading a few ulps apart. A reservoir whose choice
flips on such a difference changes the pixels within REACH of it, in this
frame and through the histories the next; the flipped DI and GI
reservoirs are counted, their share bounded (2%), and every pixel outside
their reach is held to the tolerance."""
import numpy as np
import pytest

from rtxpt_tpu.models.realtime import RealtimeRenderer as JRealtime
from rtxpt_tpu.models.renderer import realtime_config as j_realtime_config
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
from rtxpt_tpu_torch.models.renderer import realtime_config
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import procedural as TP

W, H = 16, 12
FRAMES = 2
# how far a flipped reservoir reaches within one frame, in pixels (square
# radius): DI spatial reuse (20), the denoiser (ReLAX: its clamp box,
# reprojection, variance box and four a-trous passes, 35; ReBLUR: its
# clamp box, reprojection and the history fix's wide pass of twice the
# 16-pixel base radius, 35), TAA's clamp box and Catmull-Rom fetch or
# TAAU's upsampled fetch and clip box (3)
REACH = 20 + 35 + 3


def reach(seed, h=H, w=W):
    """(h, w) pixels within REACH of any pixel of `seed`."""
    ys, xs = np.nonzero(seed)
    yy, xx = np.mgrid[:h, :w]
    return ((np.abs(yy[..., None] - ys) <= REACH)
            & (np.abs(xx[..., None] - xs) <= REACH)).any(-1)


def state(r):
    """What one frame hands the next: the DI and GI feedback reservoirs,
    as numpy."""
    return {"light": np.asarray(r.prev_reservoir.light),
            "gi_pos": np.asarray(r.prev_gi.pos),
            "gi_valid": np.asarray(r.prev_gi.valid)}


def _per_frame(frame):
    """The render_frame keywords of each frame: one dict for all frames,
    or a list of FRAMES dicts."""
    return frame if isinstance(frame, list) else [frame] * FRAMES


def reference_frames(cfg: dict, frame, w=W, h=H, scene=None):
    """(the reference renderer, [(frame, state)] of FRAMES frames);
    `frame`: render_frame's keywords (see _per_frame); `scene`: (host
    dict, the reference's camera) in place of programmer-art."""
    host, cam = scene or (JP.build_programmer_art().finish(),
                          JP.default_camera(w, h))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTXPT_SHADE_KERNEL", "1")
        mp.setenv("RTXPT_SHADE_KERNEL_INTERPRET", "1")
        mp.setenv("RTXPT_DENSE_INTERPRET", "1")
        jr = JRealtime(host, cam, j_realtime_config(**cfg),
                       env_radiance=JEM.bake_procedural_sky(height=32))
        frames = []
        for kw in _per_frame(frame):
            img = np.asarray(jr.render_frame(w, h, **kw))
            frames.append((img, state(jr)))
    return jr, frames


def port_renderer(jr, cfg: dict, tables: str, w=W, h=H, scene=None):
    """The port's RealtimeRenderer on the CPU, on its own build or on the
    reference renderer's tables; `scene`: (host dict, the port's camera)
    in place of programmer-art."""
    host, cam = scene or (TP.build_programmer_art().finish(),
                          TP.default_camera(w, h))
    r = RealtimeRenderer(host, cam, realtime_config(**cfg),
                         env_radiance=TEM.bake_procedural_sky(height=32),
                         device="cpu")
    if tables == "shared":
        r.assets = interop.assets_from_reference(jr.scene, jr.dense, jr.env,
                                                 jr.lights, device="cpu")
    return r


def compare_frames(r, frames, frame, record_property, w=W, h=H):
    """Render len(frames) frames with the port's renderer `r` and hold each
    against the reference's (the reach-masked comparison); no kernel may
    launch on CPU tensors. Returns the port's frames."""
    cuda_lib.reset_launch_counts()
    reached = np.zeros((h, w), dtype=bool)
    out = []
    for i, ((ref, ref_state), kw) in enumerate(zip(frames,
                                                   _per_frame(frame))):
        got = r.render_frame(w, h, **kw).numpy()
        assert got.shape == ref.shape
        assert np.isfinite(got).all() and got.mean() > 0.0
        st = state(r)
        flipped = (st["light"] != ref_state["light"]) | (
            st["gi_valid"] != ref_state["gi_valid"]) | ~np.isclose(
                st["gi_pos"], ref_state["gi_pos"], rtol=1e-4,
                atol=1e-4).all(-1)
        assert flipped.mean() <= 0.02, (i, flipped.sum())
        record_property(f"flipped_frame{i + 1}", int(flipped.sum()))
        # a flip in an earlier frame reaches this one through the histories
        reached = reach(flipped.reshape(h, w) | reached, h, w)
        held = ~reached
        if got.shape[:2] != (h, w):
            # a display-size frame: its pixels map onto render pixels
            sy, sx = got.shape[0] // h, got.shape[1] // w
            held = np.repeat(np.repeat(held, sy, 0), sx, 1)
        np.testing.assert_allclose(got[held], ref[held], rtol=2e-4,
                                   atol=5e-5, err_msg=f"frame {i + 1}, "
                                   f"{int(flipped.sum())} flipped")
        out.append(got)
    assert not any(cuda_lib.launch_counts().values())
    return out
