"""PSR-lite frames with one of the two ReSTIR passes, against the
reference package on the CPU: frames 1 and 2 at 16x12, max_bounces 3,
the reach-masked comparison of tests/realtime_compare.py.

  di-only-reblur: ReSTIR DI alone (its own final shade, di.final_shade),
                  denoised by ReBLUR (the PSR-lite pipeline's ReBLUR
                  frames; the stable-planes ones are in
                  tests/test_torch_reblur.py), TAA;
  gi-only:        ReSTIR GI alone (gi.final_shade), ReLAX, TAA.

The fused pipeline and the ref-vs-realtime preset are in
tests/test_torch_psr.py."""
import pytest

from realtime_compare import (compare_frames, port_renderer,
                              reference_frames)
from rtxpt_tpu_torch.denoise import reblur, relax

PIPELINES = {
    "di-only-reblur": dict(use_restir_di=True, use_restir_gi=False,
                           denoiser_enabled=True, denoiser_method="reblur",
                           use_stable_planes=False, max_bounces=3),
    "gi-only": dict(use_restir_di=False, use_restir_gi=True,
                    denoiser_enabled=True, use_stable_planes=False,
                    max_bounces=3),
}


@pytest.fixture(scope="module", params=sorted(PIPELINES))
def reference(request):
    jr, frames = reference_frames(PIPELINES[request.param], {})
    return request.param, jr, frames


@pytest.mark.parametrize("tables", ["own", "shared"])
def test_psr_restir_frames_match_reference(reference, tables,
                                           record_property):
    name, jr, frames = reference
    r = port_renderer(jr, PIPELINES[name], tables)
    compare_frames(r, frames, {}, record_property)
    state = reblur.ReblurState if name == "di-only-reblur" \
        else relax.DenoiserState
    assert isinstance(r.den_diff, state) and isinstance(r.den_spec, state)
    if name == "di-only-reblur":
        assert float(r.prev_reservoir.m.max()) > 8.0
        assert not bool(r.prev_gi.valid.any())
    else:
        assert float(r.prev_reservoir.m.max()) == 0.0
        assert bool(r.prev_gi.valid.any())
