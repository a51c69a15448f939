"""The benchmark's realtime cell on the CPU (programmer-art at 16x12, 3
bounces; tests/realtime_bench.py): the port's RealtimeRenderer against
the plain realtime reference (benchmark/refpt/realtime) frame by frame,
the check that decides `correct` (benchmark/benchlib/check_rt.py) on the
port's own frame, against three planted faults and against its bfloat16
control, and the port's realtime counters, which read the device only
while recording.

Tolerance on the whole frames: rtol 2e-4 / atol 5e-5, as the port's
realtime tests against the JAX package (tests/test_torch_realtime.py):
the port traces programmer-art with its dense trace, the reference with
its brute-force trace, whose winners' t and (u, v) are solved again from
the triangle and may differ in the last bits; nothing else differs."""
import numpy as np
import pytest
import torch

import realtime_bench as RB
from benchlib import check_rt, scenes, sweep
from refpt.realtime import frame as RF
from refpt.realtime.config import RTConfig
from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
from rtxpt_tpu_torch.models.renderer import realtime_config
from rtxpt_tpu_torch.scene.camera import look_at
from rtxpt_tpu_torch.utils import profiling

W, H = RB.W, RB.H
FRAMES = 3


def _port(cfg):
    host, env = scenes.host_scene(cfg), scenes.env_radiance(cfg)
    eye0, target, fov = scenes.camera(cfg)
    return RealtimeRenderer(host, look_at(W, H, eye0, target, fov_y=fov),
                            realtime_config(**cfg["settings"]),
                            env_radiance=env, device="cpu")


def test_port_frames_match_the_plain_reference():
    torch.set_num_threads(4)
    _, cfg = RB.cell_files()
    host, env = scenes.host_scene(cfg), scenes.env_radiance(cfg)
    eye0, target, fov = scenes.camera(cfg)
    dev = torch.device("cpu")
    assets = RF.make_assets(host, env, dev)
    rcfg = RTConfig(**cfg["settings"]).check()
    hist = RF.History(prev_cam=RF.view_camera(W, H, eye0, target, fov, None,
                                              dev))
    r = _port(cfg)
    for f in range(FRAMES):
        eye = sweep.eye(eye0, target, f)
        want, hist, res, stacks = RF.render_frame(
            assets, rcfg, RF.view_camera(W, H, eye, target, fov, f, dev),
            hist, W, H)
        got = r.render_frame(W, H, camera=look_at(W, H, eye, target,
                                                  fov_y=fov))
        assert np.isfinite(got.numpy()).all() and float(got.mean()) > 0.0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=5e-5, err_msg=f"frame {f + 1}")
        np.testing.assert_array_equal(r.last_stable_planes.branch_id.numpy(),
                                      res.planes.branch_id.numpy())
        np.testing.assert_array_equal(r.prev_reservoir.light.numpy(),
                                      res.di_feedback.light.numpy())
        np.testing.assert_allclose(r.last_plane_denoised[0].numpy(),
                                   stacks[0].numpy(), rtol=2e-4, atol=5e-5)
    # the third frame reused the histories of the first two
    assert float(r.prev_reservoir.m.max()) > 8.0
    assert hist.taa.valid and float(hist.den_states[0][0].history.max()) \
        >= 3.0


@pytest.fixture(scope="module")
def sound():
    return RB.run_mode(seed=5)


def test_the_check_passes_on_the_port_frame(sound):
    assert sound["correct"], sound["numbers"]
    n = sound["numbers"]
    assert n["pixels"] == 64 and n["frame_index_off"] == 0
    assert all(n[f"{q}_off_share"] == 0.0 for q in check_rt.QUANTITIES), n
    # the check frame ran on histories: temporal reuse, denoiser, TAA
    snap = sound["replay"]["snap"]
    assert snap["di"] is not None and snap["taa"].valid
    assert snap["frame_index"] == 3


def test_the_bfloat16_control_fails(sound):
    numbers = check_rt.replay(**sound["replay"], control=True)
    assert not check_rt.verdict(numbers), numbers
    assert numbers["planes_off_share"] > 0.02, numbers


def _taa_history_unchanged(monkeypatch):
    from rtxpt_tpu_torch.post import taa
    orig = taa.resolve

    def resolve(state, color, *a, **kw):
        out, new = orig(state, color, *a, **kw)
        return (out if state is None or not state.valid
                else state.history), new
    monkeypatch.setattr(taa, "resolve", resolve)


def _relax_skipped(monkeypatch):
    from rtxpt_tpu_torch.denoise import relax
    orig = relax.denoise

    def denoise(state, radiance, *a, **kw):
        _, new = orig(state, radiance, *a, **kw)
        return radiance, new
    monkeypatch.setattr(relax, "denoise", denoise)


def _fill_scaled(monkeypatch):
    from rtxpt_tpu_torch.pt import integrator
    orig = integrator.render_paths

    def render_paths(*a, **kw):
        out = orig(*a, **kw)
        if isinstance(out, dict):
            out = dict(out, committed_diff=out["committed_diff"] * 1.01,
                       committed_spec=out["committed_spec"] * 1.01)
        return out
    monkeypatch.setattr(integrator, "render_paths", render_paths)


@pytest.mark.parametrize("fault", [_taa_history_unchanged, _relax_skipped,
                                   _fill_scaled],
                         ids=["taa_history_unchanged", "relax_skipped",
                              "fill_radiance_scaled"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = RB.run_mode(seed=11)
    assert not res["correct"], res["numbers"]


def test_counters_read_the_device_only_while_recording(monkeypatch):
    reads = []
    orig = profiling.count_device

    def spy(name, value):
        orig(name, lambda: (reads.append(name), value())[1])
    monkeypatch.setattr(profiling, "count_device", spy)
    _, cfg = RB.cell_files()
    r = _port(cfg)
    r.render_frame(W, H)
    r.render_frame(W, H)
    assert reads == []
    with profiling.record() as rec:
        r.render_frame(W, H)
    names = {"stableplanes.stored", "restir_di.valid", "restir_gi.valid"}
    assert set(reads) == names
    counters = rec.calls[-1].counters
    assert names <= set(counters) and counters["stableplanes.stored"] \
        >= W * H
    assert 0 < counters["restir_di.valid"] <= W * H
    assert 0 < counters["bounce.live"] <= counters["bounce.width"]
    # one sync span per counter read, beside the loop's own
    assert rec.calls[-1].spans["sync"][0] >= len(names)
