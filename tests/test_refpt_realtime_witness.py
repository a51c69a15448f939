"""A witness of the benchmark's plain realtime reference
(benchmark/refpt/realtime), which shares none of its code: the JAX
package's RealtimeRenderer, from which the port was written, on the same
frames. Programmer-art at 16x12, the realtime cell's settings with 3
bounces, frames 1 (no history) and 2 (temporal reuse, denoiser and TAA
history) on the cell's sweeping camera; the reference renders every pixel
of each frame (refpt.realtime.frame.render_frame).

Tolerance on the HDR frame: rtol 2e-4 / atol 5e-5, as the port's own
realtime tests against the JAX package (tests/test_torch_realtime.py):
the JAX package's dense trace drops low mantissa bits of t when it picks
a winner, and XLA and PyTorch round the shading a few ulps apart. The
flipped DI and GI reservoirs are counted and their share bounded (2%);
every pixel outside their reach (tests/realtime_compare.py REACH) is held
to the tolerance.

Marked slow: the JAX package traces and runs its frame programs in
interpret mode, about two minutes on one CPU worker, past the minute the
tier-1 run allows a test; run it with -m slow."""
import numpy as np
import pytest
import torch

import realtime_bench as RB
from benchlib import scenes, sweep
from realtime_compare import reach
from refpt.realtime import frame as RF
from refpt.realtime.config import RTConfig

W, H = RB.W, RB.H
FRAMES = 2


@pytest.mark.slow
def test_refpt_realtime_agrees_with_the_jax_package(monkeypatch):
    pytest.importorskip("jax")
    monkeypatch.setenv("RTXPT_SHADE_KERNEL", "1")
    monkeypatch.setenv("RTXPT_SHADE_KERNEL_INTERPRET", "1")
    monkeypatch.setenv("RTXPT_DENSE_INTERPRET", "1")
    from rtxpt_tpu.models.realtime import RealtimeRenderer as JRealtime
    from rtxpt_tpu.models.renderer import realtime_config as j_config
    from rtxpt_tpu.scene import envmap as JEM
    from rtxpt_tpu.scene import procedural as JP
    from rtxpt_tpu.scene.camera import look_at as j_look_at

    torch.set_num_threads(4)
    _, cfg = RB.cell_files()
    eye0, target, fov = scenes.camera(cfg)
    jr = JRealtime(JP.build_programmer_art().finish(),
                   j_look_at(W, H, eye0, target, fov_y=fov),
                   j_config(**cfg["settings"]),
                   env_radiance=JEM.bake_procedural_sky(
                       height=int(cfg["env"]["sky_rows"])))
    dev = torch.device("cpu")
    assets = RF.make_assets(scenes.host_scene(cfg), scenes.env_radiance(cfg),
                            dev)
    rcfg = RTConfig(**cfg["settings"]).check()
    hist = RF.History(prev_cam=RF.view_camera(W, H, eye0, target, fov, None,
                                              dev))
    reached = np.zeros((H, W), dtype=bool)
    for f in range(FRAMES):
        eye = sweep.eye(eye0, target, f)
        want = np.asarray(jr.render_frame(
            W, H, camera=j_look_at(W, H, eye, target, fov_y=fov)))
        got, hist, res, _ = RF.render_frame(
            assets, rcfg, RF.view_camera(W, H, eye, target, fov, f, dev),
            hist, W, H)
        got = got.numpy()
        assert np.isfinite(got).all() and got.mean() > 0.0
        flipped = (res.di_feedback.light.numpy()
                   != np.asarray(jr.prev_reservoir.light)) | (
            res.gi_feedback.valid.numpy() != np.asarray(jr.prev_gi.valid)) \
            | ~np.isclose(res.gi_feedback.pos.numpy(),
                          np.asarray(jr.prev_gi.pos), rtol=1e-4,
                          atol=1e-4).all(-1)
        assert flipped.mean() <= 0.02, (f, int(flipped.sum()))
        reached = reach(flipped.reshape(H, W) | reached)
        held = ~reached
        np.testing.assert_allclose(got[held], want[held], rtol=2e-4,
                                   atol=5e-5, err_msg=f"frame {f + 1}, "
                                   f"{int(flipped.sum())} flipped")
    assert float(hist.di.m.max()) > 8.0
