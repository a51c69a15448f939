"""One realtime frame of the textured, alpha-MASK scene of
tests/textured_scene.py (PSR-lite with ReSTIR DI + GI, ReLAX and TAA,
max_bounces 3) through the port's RealtimeRenderer against the
reference's, by tests/realtime_compare.py's reach-masked comparison: the
texture taps, the path loop's ray cones and the exact alpha test of the
fused ReSTIR visibility trace and the NEE rays; on the port's own tables
and on the reference's (interop: its texture stack and the dense table's
opacity masks carried over)."""
import pytest

import textured_scene as TS
from realtime_compare import compare_frames, port_renderer, reference_frames
from rtxpt_tpu.scene import build as JB
from rtxpt_tpu.scene import camera as JC
from rtxpt_tpu_torch.scene import build as TB
from rtxpt_tpu_torch.scene import camera as TC

CFG = dict(use_restir_di=True, use_restir_gi=True, denoiser_enabled=True,
           use_stable_planes=False, max_bounces=3)
FRAME = [dict()]          # one frame


@pytest.fixture(scope="module")
def reference():
    jr, frames = reference_frames(
        CFG, FRAME, scene=(TS.build(JB.SceneBuilder, JB.Mesh),
                           TS.camera(JC)))
    assert jr.cfg.exact_alpha_test and jr.dense.has_omm
    return jr, frames


@pytest.mark.parametrize("tables", ["own", "shared"])
def test_textured_frame_matches_reference(reference, tables,
                                          record_property):
    jr, frames = reference
    r = port_renderer(jr, CFG, tables, scene=(
        TS.build(TB.SceneBuilder, TB.Mesh), TS.camera(TC)))
    assert r.cfg.exact_alpha_test and r.assets.scene.textures is not None
    assert r.assets.accel.has_omm
    compare_frames(r, frames, FRAME, record_property)
