"""The correctness check against the control and against faults planted
in the port, driving the reference mode's run on the CPU at a small size
(the harness's look for a chip is skipped: the mode's driver is called
directly). CPU only, about a minute."""
import time
import types

import pytest
import torch

import _paths  # noqa: F401
import run
from benchlib import check

CELL = "art_ref_800x600"


def _run(seed: int = 5):
    torch.set_num_threads(4)
    _, traffic, cfg = run.load_cell(run.read_manifest(), CELL)
    traffic = dict(traffic, width=16, height=12, spp_per_call=2,
                   check={"pixels": 64})
    ctx = types.SimpleNamespace(workload=traffic, config=cfg, seed=seed,
                                seconds=0.0, trace=False, device="cpu",
                                t_process=time.perf_counter())
    mode = run.load_file(run.BENCH / "modes" / "reference.py",
                         "bench_mode_reference")
    return mode.run(ctx)


def test_sound_run_is_correct_and_the_control_is_not():
    res = _run()
    assert res["correct"], res["numbers"]
    assert res["numbers"]["pixels_off_share"] == 0.0
    rp = res["replay"]
    control = check.reference_pixels(**rp, control=True)
    numbers = check.compare(control, res["reference"])
    assert not check.verdict(numbers), numbers


def _stale_render(monkeypatch):
    from rtxpt_tpu_torch.models import renderer as R
    orig = R.Renderer.render

    def render(self, *a, **kw):
        # the accumulation as the call found it (empty: zeros)
        keep = None if self.accum is None else self.accum.clone()
        orig(self, *a, **kw)
        self.accum = torch.zeros_like(self.accum) if keep is None else keep
        return self.accum
    monkeypatch.setattr(R.Renderer, "render", render)


def _half_the_samples(monkeypatch):
    from rtxpt_tpu_torch.pt import integrator as I
    orig = I.render_wavefront

    def render_wavefront(*a, spp=1, **kw):
        half = max(spp // 2, 1)
        return orig(*a, spp=half, **kw) * (spp / half)
    monkeypatch.setattr(I, "render_wavefront", render_wavefront)


def _altered_radiance(monkeypatch):
    from rtxpt_tpu_torch.pt import integrator as I
    orig = I.render_wavefront

    def render_wavefront(*a, **kw):
        return orig(*a, **kw) * 1.01
    monkeypatch.setattr(I, "render_wavefront", render_wavefront)


@pytest.mark.parametrize("fault", [_stale_render, _half_the_samples,
                                   _altered_radiance],
                         ids=["state_unchanged", "half_the_batch",
                              "answer_altered"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _run(seed=11)
    assert not res["correct"], res["numbers"]
