"""The port's own spans and counters (rtxpt_tpu_torch/utils/profiling.py)
in reference-mode renders of programmer-art at 16x12, 2 spp, 1 bounce,
on the CPU: off they are one shared no-op and reach no profiler; recorded
under torch.profiler they are `rtxpt:` ranges, the NEE visibility trace
inside the shade step; recorded, the bounce loop's counters agree with
the integrator's ray statistics, the build and call records are whole,
and the image is bit-identical to the one rendered with recording off."""
import pytest
import torch

from rtxpt_tpu_torch import config as C
from rtxpt_tpu_torch.models import renderer as R
from rtxpt_tpu_torch.pt import integrator
from rtxpt_tpu_torch.scene import envmap as EM
from rtxpt_tpu_torch.scene import procedural
from rtxpt_tpu_torch.utils import profiling

W, H, SPP = 16, 12, 2


@pytest.fixture(scope="module")
def recorded():
    """(recorder, renderer, image) of a Renderer built and rendered once
    with recording on."""
    host = procedural.build_programmer_art().finish()
    with profiling.record() as rec:
        r = R.Renderer(host, procedural.default_camera(W, H),
                       R.reference_config(max_bounces=1,
                                          max_diffuse_bounces=1),
                       env_radiance=EM.bake_procedural_sky(height=16),
                       device="cpu")
        img = r.render(W, H, SPP).clone()
    return rec, r, img


def _render(r):
    r.reset_accumulation()
    return r.render(W, H, SPP)


def _profiled_render(r):
    """(name, start ns, end ns) of the host events of a render under
    torch.profiler, from its raw events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _render(r)
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]


def test_span_off_is_shared_noop(recorded):
    rec, r, _ = recorded
    assert profiling.span("bounce") is profiling.span("render")
    assert profiling.count("bounce.live", 3) is None
    with profiling.record():
        assert profiling.span("bounce") is not profiling.span("bounce")
    assert profiling.span("sync") is profiling.span("shade")
    events = _profiled_render(r)
    assert events and not any(n.startswith(profiling.PREFIX)
                              for n, _, _ in events)
    assert len(rec.calls) == 1 and rec.counts["render"] == 1


def test_profiler_ranges_nest(recorded):
    with profiling.record() as rec:
        events = _profiled_render(recorded[1])
    spans = {}
    for name, s, e in events:
        spans.setdefault(name, []).append((s, e))
    for n in ("render", "entry", "bounce", "sync", "surface", "shade",
              "regen", "trace_closest", "trace_anyhit"):
        assert profiling.PREFIX + n in spans, n
    anyhit = spans[profiling.PREFIX + "trace_anyhit"]
    shade = spans[profiling.PREFIX + "shade"]
    assert anyhit and all(any(s0 <= a0 and a1 <= s1 for s0, s1 in shade)
                          for a0, a1 in anyhit)
    assert [c.profiled for c in rec.calls] == [True]


def test_recorded_counters_match_ray_stats(recorded):
    r = recorded[1]
    px, py = r._pixel_grid(W, H)
    cam = r._camera(W, H, R.r2_jitter(0))
    with profiling.record() as rec:
        _, rays = integrator.render_wavefront_counted(
            r.assets, cam, px, py, C.default_constants(), cfg=r.cfg,
            spp=SPP)
    bounces = rec.counts["bounce"]
    assert bounces > 2
    assert rec.counters["bounce.live"] == int(rays[0])
    # each iteration traces its closest hits once (no injected hit)
    assert rec.counts["trace_closest"] == bounces
    assert rec.counters["bounce.width"] == bounces * W * H
    assert rec.counts["sync"] > bounces and not rec.calls


def test_recording_keeps_the_image_and_the_call_record(recorded):
    rec, r, img = recorded
    assert torch.equal(img, _render(r))
    for n in ("build/env", "build/lights", "build/omm", "build/accel",
              "build/tables"):
        assert rec.counts[n] == 1, n
    (call,) = rec.calls
    assert call.index == 0 and not call.profiled
    assert call.spans["render"][0] == 1
    assert call.spans["render"][1] == call.wall > 0.0
    assert abs(sum(s[2] for s in call.spans.values()) - call.wall) < 1e-6
    assert call.counters["bounce.live"] == rec.counters["bounce.live"] > 0
    assert "build/accel" not in call.spans
    assert "per render call (1 calls" in rec.report()
