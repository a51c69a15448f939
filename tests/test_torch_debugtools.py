"""The debug tools of rtxpt_tpu_torch/utils/ against the reference
package on the CPU: the DebugPrint slots (debugprint.py), the debug lines
(debuglines.py), the delta-tree explorer (deltatree.py) and the frame
profiler (profiling.py).

Both packages trace the same tables (programmer-art; the reference's
SceneArrays, dense planes, EnvMap and LightTable carried into the port by
`interop.assets_from_reference`). print_path's slots: labels equal,
values within 1e-5. lines_for_path's buffers within 1e-5 (endpoints
within 1e-5 of their segment's length); the overlay
(rasterize_overlay) on the same buffer and image within 1e-6. The delta
tree on the glass pixel of tests/test_deltatree.py (160x120): the same
nodes in the same order, integers and flags equal, floats within rtol
1e-5, and the same text from format_tree; format_slots the same text. On
the city (the two-level BVH8 tier, the port's own build) the three tools
run and agree with the port's G-buffer. The profiler's report is the
reference's text on the same totals, and trace() writes a Chrome trace on
the CPU."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import reference_config as j_reference_config
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu.utils import debuglines as JDL
from rtxpt_tpu.utils import debugprint as JDP
from rtxpt_tpu.utils import deltatree as JDT
from rtxpt_tpu.utils import profiling as JPR
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.ops import bvh2l
from rtxpt_tpu_torch.pt import gbuffer as TGB
from rtxpt_tpu_torch.scene import camera as TCAM
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import procedural as TP
from rtxpt_tpu_torch.utils import debuglines as TDL
from rtxpt_tpu_torch.utils import debugprint as TDP
from rtxpt_tpu_torch.utils import deltatree as TDT
from rtxpt_tpu_torch.utils import profiling as TPR

W, H = 32, 24
TREE_W, TREE_H = 160, 120
ATOL = 1e-5
PIXELS = ((W // 2, H // 2), (20, 15), (6, 4))


def _port_camera(cam):
    return TCAM.CameraData(*(torch.as_tensor(np.array(f, np.float32))
                             for f in cam))


def _shared(width, height, max_bounces):
    """(reference renderer, its camera with the viewport set, the port's
    assets on the reference's tables, the port's camera)."""
    jr = JRenderer(JP.build_programmer_art().finish(),
                   JP.default_camera(width, height),
                   j_reference_config(max_bounces=max_bounces),
                   env_radiance=JEM.bake_procedural_sky(height=32))
    jcam = jr.camera._replace(viewport=jnp.asarray([width, height],
                                                   jnp.float32))
    ta = interop.assets_from_reference(jr.scene, jr.dense, jr.env,
                                       jr.lights, device="cpu")
    return jr, jcam, ta, _port_camera(jcam)


@pytest.fixture(scope="module")
def art():
    return _shared(W, H, 2)


@pytest.mark.parametrize("max_bounces", [2, 6])
@pytest.mark.parametrize("pixel", PIXELS)
def test_print_path_matches_reference(art, pixel, max_bounces):
    jr, jcam, ta, tcam = art
    got = TDP.print_path(ta, tcam, *pixel, max_bounces=max_bounces)
    ref = JDP.print_path(jr.assets, jcam, *pixel, max_bounces=max_bounces)
    assert [s["label"] for s in got] == [s["label"] for s in ref]
    assert [s["slot"] for s in got] == [s["slot"] for s in ref]
    for g, r in zip(got, ref):
        assert g["value"].dtype == np.float32 and g["value"].shape == (4,)
        np.testing.assert_allclose(g["value"], r["value"], rtol=0,
                                   atol=ATOL, err_msg=g["label"])
    assert TDP.format_slots(got) == JDP.format_slots(ref)
    assert 2 <= len(got) <= TDP.MAX_DEBUG_PRINT_SLOTS


@pytest.mark.parametrize("pixel", PIXELS)
def test_lines_for_path_matches_reference(art, pixel):
    jr, jcam, ta, tcam = art
    got = TDL.lines_for_path(ta, tcam, *pixel, max_bounces=3)
    ref = JDL.lines_for_path(jr.assets, jcam, *pixel, max_bounces=3)
    assert int(got.count) == int(ref.count) == 4
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color),
                               rtol=0, atol=ATOL)
    # endpoints within 1e-5 of the segment's length (at least 1e-5): a
    # miss segment runs 25 units along its direction, whose rounding it
    # scales
    length = np.linalg.norm(np.asarray(ref.b) - np.asarray(ref.a), axis=-1)
    tol = ATOL * np.maximum(length, 1.0)[:, None]
    for name in ("a", "b"):
        diff = np.abs(getattr(got, name).numpy()
                      - np.asarray(getattr(ref, name)))
        assert (diff <= tol).all(), (name, diff.max())
    # the overlay on the reference's own buffer and image
    img = np.random.RandomState(pixel[0]).rand(H, W, 3).astype(np.float32)
    img *= 0.5
    conv = TDL.LineBuffer(*(torch.as_tensor(np.array(f)) for f in ref))
    out = TDL.rasterize_overlay(torch.as_tensor(img), conv, tcam).numpy()
    want = np.asarray(JDL.rasterize_overlay(jnp.asarray(img), ref, jcam))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
    assert (out != img).any()


def test_aabb_overlay_matches_reference(art):
    jr, jcam, ta, tcam = art
    pos = np.asarray(jr.scene.positions)
    got = TDL.add_aabb(TDL.LineBuffer.empty(device="cpu"), pos.min(0),
                       pos.max(0))
    ref = JDL.add_aabb(JDL.LineBuffer.empty(), pos.min(0), pos.max(0))
    assert int(got.count) == int(ref.count) == 12
    for name in ("a", "b", "color"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    img = np.zeros((H, W, 3), np.float32)
    out = TDL.rasterize_overlay(torch.as_tensor(img), got, tcam).numpy()
    want = np.asarray(JDL.rasterize_overlay(jnp.asarray(img), ref, jcam))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
    assert out.max() > 0.0


def test_add_lines_drops_past_capacity():
    buf = TDL.LineBuffer.empty(capacity=4, device="cpu")
    a = np.arange(18, dtype=np.float32).reshape(6, 3)
    buf = TDL.add_lines(buf, a, a + 1.0, (1.0, 0.0, 0.0))
    assert int(buf.count) == 4
    np.testing.assert_array_equal(buf.a[:3].numpy(), a[:3])


# ---- the delta tree ------------------------------------------------------

@pytest.fixture(scope="module")
def glass():
    """The reference's forking glass pixel (tests/test_deltatree.py's
    probe) with both packages' trees."""
    jr, jcam, ta, tcam = _shared(TREE_W, TREE_H, 6)
    for y in (73, 71, 75):
        for x in (88, 86, 90, 84, 92):
            ref = JDT.explore_pixel(jr.assets, jcam, x, y,
                                    max_vertex_depth=3)
            if any(len(n.lobes) >= 2 for n in ref.nodes):
                got = TDT.explore_pixel(ta, tcam, x, y, max_vertex_depth=3)
                return got, ref
    pytest.fail("no forking delta tree found on the glass row")


def test_delta_tree_matches_reference(glass):
    got, ref = glass
    assert got.pixel == ref.pixel
    assert got.plane_branch_ids == ref.plane_branch_ids
    assert got.dominant_plane == ref.dominant_plane
    assert len(got.nodes) == len(ref.nodes) > 2
    for g, r in zip(got.nodes, ref.nodes):
        for key in ("vertex_index", "branch_id", "material_id", "is_miss",
                    "plane_slot", "on_stable_path", "is_dominant"):
            assert getattr(g, key) == getattr(r, key), key
        assert [l for l, _ in g.lobes] == [l for l, _ in r.lobes]
        np.testing.assert_allclose([v for _, v in g.lobes],
                                   [v for _, v in r.lobes], rtol=1e-5)
        for key in ("throughput", "world_pos", "volume_absorption",
                    "non_delta_part"):
            np.testing.assert_allclose(getattr(g, key), getattr(r, key),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
    fork = next(n for n in got.nodes if len(n.lobes) >= 2)
    assert {l for l, _ in fork.lobes} == {TDT.LOBE_REFLECTION,
                                          TDT.LOBE_TRANSMISSION}
    assert TDT.format_tree(got) == JDT.format_tree(ref)


# ---- the two-level tier (the port's own build) --------------------------

def test_tools_on_the_city():
    w, h = 64, 36
    r = Renderer(TP.build_city().finish(), TP.city_camera(w, h),
                 reference_config(max_bounces=3),
                 env_radiance=TEM.bake_procedural_sky(height=32),
                 device="cpu")
    assert isinstance(r.accel, bvh2l.BVH8TwoLevel)
    cam = r._camera(w, h, (0.0, 0.0))
    x, y = w // 2, h // 2
    gb = TGB.trace_gbuffer(r.assets, cam, cam, torch.tensor([x]),
                           torch.tensor([y]), psr_depth=0)
    slots = TDP.print_path(r.assets, cam, x, y, max_bounces=3)
    assert slots[1]["label"] == ("v0.hit" if bool(gb.valid[0])
                                 else "v0.miss")
    if bool(gb.valid[0]):
        assert slots[1]["value"][1] == float(gb.prim[0])
        np.testing.assert_allclose(slots[1]["value"][0], float(gb.t[0]),
                                   rtol=1e-6)
    buf = TDL.lines_for_path(r.assets, cam, x, y, max_bounces=3)
    assert int(buf.count) == 4
    img = TDL.rasterize_overlay(torch.zeros(h, w, 3), buf, cam)
    assert img.max() > 0.0
    viz = TDT.explore_pixel(r.assets, cam, x, y, max_vertex_depth=3)
    assert viz.nodes and viz.nodes[0].vertex_index == 1
    assert "delta tree @ pixel" in TDT.format_tree(viz)


# ---- profiling ------------------------------------------------------------

def test_profiler_report_matches_reference():
    got, ref = TPR.FrameProfiler(), JPR.FrameProfiler()
    for name, tot, count in (("gbuffer", 0.0123, 3), ("restir_di", 0.5, 7),
                             ("denoise", 1e-5, 1), ("a" * 30, 2.25, 9)):
        for p in (got, ref):
            p.totals[name] = tot
            p.counts[name] = count
    assert got.report() == ref.report()


def test_profiler_scope_counts():
    prof = TPR.FrameProfiler()
    x = torch.ones(4)
    for _ in range(3):
        with prof.scope("stage", sync_on=(x, {"y": [x]})):
            x = x + 1.0
    assert prof.counts["stage"] == 3 and prof.totals["stage"] > 0.0
    assert prof.report().splitlines()[1].startswith("stage")


def test_trace_writes_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with TPR.trace(str(log_dir)) as prof:
        with TPR.span("realtime/probe"):
            torch.ones(64).sum()
    assert os.path.dirname(prof.trace_path) == str(log_dir)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "rtxpt:realtime/probe" for e in events)
