"""The debug views (rtxpt_tpu_torch/utils/debugviews.py) against the
reference package on the CPU.

Both packages trace the same tables: programmer-art at 32x24, the
reference's SceneArrays, dense planes, EnvMap and LightTable carried into
the port by `interop.assets_from_reference` (the reference's dense trace
runs through its XLA path, as its own tests run it). Every surface view:
the hashed views (MaterialID, FirstHitShaderPermutation) bit-equal on the
pixels whose G-buffer prim agrees, the rest within atol 1e-5. The OMM
views on the textured scene of tests/textured_scene.py (the port's bake
by triangle against the reference's BVH leaves; the overlay, which
blends in the texture-sampled albedo, within the G-buffer's atol 5e-5)
and on programmer-art, whose triangles carry no mask. The pipeline views
on identical seeded inputs (stable planes, plane radiance and denoised
stacks, denoiser states, a PSR-lite frame's outputs; NaNSanitizer) for
plane_index -1, 0 and 1, within atol 1e-6. The ReSTIR DI stage views and
ReGIRIndirectOutput within rtol 1e-4 / atol 1e-5 (tests/
test_torch_restir.py's tolerance) off the pixels whose reservoir picked
another sample, a one-ulp target difference flipping the pick, at most 2%
of them. inspect_pixel field by field."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import textured_scene as TS
from rtxpt_tpu.models import realtime as JRT
from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import reference_config as j_reference_config
from rtxpt_tpu.denoise import relax as JRX
from rtxpt_tpu.pt import gbuffer as JGB
from rtxpt_tpu.pt import stableplanes as JSP
from rtxpt_tpu.restir import di as JDI
from rtxpt_tpu.restir import gi as JGI
from rtxpt_tpu.restir import reservoir as JRS
from rtxpt_tpu.scene import build as JB
from rtxpt_tpu.scene import camera as JC
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu.utils import debugviews as JDV
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.pt import gbuffer as TGB
from rtxpt_tpu_torch.restir import di as TDI
from rtxpt_tpu_torch.scene import build as TB
from rtxpt_tpu_torch.scene import camera as TCAM
from rtxpt_tpu_torch.scene import omm as TOMM
from rtxpt_tpu_torch.scene import procedural as TP
from rtxpt_tpu_torch.utils import debugviews as TDV

W, H = 32, 24
N = W * H
P = 3
ATOL = 1e-5
ATOL_TEXTURED = 5e-5
RTOL_RESTIR, ATOL_RESTIR = 1e-4, 1e-5
MAX_FLIPPED = 0.02
HASHED = ("MaterialID", "FirstHitShaderPermutation")
OMM_VIEWS = ("FirstHitOpacityMicroMapInWorld",
             "FirstHitOpacityMicroMapOverlay")
PIPELINE_PREFIXES = ("Denoiser", "ReSTIR", "StablePlane", "StableRadiance",
                     "NaN", "Secondary", "ReGIR")
SURFACE_VIEWS = [v for v in JDV.VIEWS if not v.startswith(PIPELINE_PREFIXES)]
# the views that shade a reservoir on the re-traced G-buffer
RESTIR_VIEWS = ("ReSTIRDIInitialOutput", "ReSTIRDITemporalOutput",
                "ReSTIRDISpatialOutput", "ReGIRIndirectOutput")
PIPELINE_VIEWS = [v for v in JDV.VIEWS if v.startswith(PIPELINE_PREFIXES)
                  and v not in RESTIR_VIEWS]


def _port_camera(cam):
    """The port's CameraData of the reference's camera."""
    return TCAM.CameraData(*(torch.as_tensor(np.array(f, np.float32))
                             for f in cam))


class _World:
    """One scene traced by both packages on the same tables."""

    def __init__(self, host_j, host_t, cam_j, width, height):
        self.jr = JRenderer(host_j, cam_j, j_reference_config(max_bounces=2),
                            env_radiance=JEM.bake_procedural_sky(height=32))
        self.jcam = self.jr.camera._replace(
            jitter=jnp.zeros(2),
            viewport=jnp.asarray([width, height], jnp.float32))
        self.tcam = _port_camera(self.jcam)
        accel = self.jr.dense if self.jr.dense is not None else self.jr.bvh
        self.ta = dataclasses.replace(
            interop.assets_from_reference(self.jr.scene, accel, self.jr.env,
                                          self.jr.lights, device="cpu"),
            tri_omm=torch.as_tensor(TOMM.bake_opacity_masks(host_t)))
        self.w, self.h = width, height
        self.jpx, self.jpy = self.jr._pixel_grid(width, height)
        self.px = torch.as_tensor(np.asarray(self.jpx).astype(np.int64))
        self.py = torch.as_tensor(np.asarray(self.jpy).astype(np.int64))
        self.jgb = JGB.trace_gbuffer(self.jr.assets, self.jcam, self.jcam,
                                     self.jpx, self.jpy)
        self.tgb = TGB.trace_gbuffer(self.ta, self.tcam, self.tcam, self.px,
                                     self.py)

    def views(self, view, **kw):
        """(port image, reference image) as numpy."""
        got = TDV.render_debug_view(view, self.ta, self.tcam, self.w,
                                    self.h, **kw.get("port", {}))
        ref = JDV.render_debug_view(view, self.jr.assets, self.jcam, self.w,
                                    self.h, **kw.get("ref", {}))
        return got.numpy(), np.asarray(ref)


@pytest.fixture(scope="module")
def art():
    return _World(JP.build_programmer_art().finish(),
                  TP.build_programmer_art().finish(),
                  JP.default_camera(W, H), W, H)


@pytest.fixture(scope="module")
def textured():
    return _World(TS.build(JB.SceneBuilder, JB.Mesh),
                  TS.build(TB.SceneBuilder, TB.Mesh), TS.camera(JC, W, H),
                  W, H)


def test_view_lists_match_reference():
    assert TDV.VIEWS == JDV.VIEWS
    assert TDV._ALIASES == JDV._ALIASES


def test_surface_hits_agree(art):
    """The two G-buffers see the same triangles on every pixel, so every
    surface view is held on every pixel."""
    np.testing.assert_array_equal(art.tgb.prim.numpy(),
                                  np.asarray(art.jgb.prim))
    assert art.tgb.valid.any() and (~art.tgb.valid).any()


@pytest.mark.parametrize("view", SURFACE_VIEWS)
def test_surface_view_matches_reference(art, view):
    got, ref = art.views(view)
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    assert np.isfinite(got).all()
    if view in HASHED:
        same = (art.tgb.prim.numpy() == np.asarray(art.jgb.prim)) \
            .reshape(H, W)
        np.testing.assert_array_equal(got[same], ref[same])
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("view", OMM_VIEWS)
def test_omm_views_on_masked_scene(textured, view):
    """The textured scene's alpha-MASK triangles carry masks: the view
    shows their cells (the trace skips transparent cells, so the camera
    sees opaque ones) beside unmasked triangles; the port reads its bake
    by triangle, the reference its BVH's leaves."""
    got, ref = textured.views(view)
    # the overlay blends in the texture-sampled diffuse albedo, which the
    # G-buffer parity (tests/test_torch_psr.py) holds at atol 5e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL if view.endswith(
        "InWorld") else ATOL_TEXTURED)
    if view.endswith("InWorld"):
        masked = np.isclose(got, [0.1, 0.85, 0.1]).all(-1)
        unmasked = np.isclose(got, [0.3, 0.3, 0.35]).all(-1)
        assert masked.any() and unmasked.any()


def test_omm_view_without_masks(art):
    got, _ = art.views("FirstHitOpacityMicroMapInWorld")
    hit = art.tgb.valid.numpy().reshape(H, W)
    np.testing.assert_allclose(got[hit], np.broadcast_to(
        [0.3, 0.3, 0.35], got[hit].shape), atol=1e-7)
    assert (got[~hit] == 0.0).all()


# ---- the pipeline views on seeded inputs --------------------------------

def _seeded_inputs(seed, lights: int):
    """(reference keywords, port keywords) of identical seeded pipeline
    inputs: stable planes, plane radiance and denoised stacks, per-plane
    ReLAX states, a PSR-lite frame's outputs and a colour with non-finite
    pixels."""
    rs = np.random.RandomState(seed)
    f = lambda *shape: rs.rand(*shape).astype(np.float32)
    branch = rs.choice(np.asarray([1, 4, 5, 17, JSP.INVALID_BRANCH],
                                  np.uint32), (N, P))
    branch[: N // 2, 0] = 1
    sp = JSP.StablePlanes(
        branch_id=jnp.asarray(branch),
        vertex_index=jnp.asarray(rs.randint(1, 4, (N, P)).astype(np.int32)),
        prim=jnp.asarray(rs.randint(-1, 50, (N, P)).astype(np.int32)),
        bary=jnp.asarray(f(N, P, 2)), ray_dir=jnp.asarray(f(N, P, 3) - 0.5),
        scene_length=jnp.asarray(f(N, P) * 20.0),
        thp=jnp.asarray(f(N, P, 3)),
        interior=jnp.asarray(rs.randint(0, 5, (N, P, 2)).astype(np.uint32)),
        normal=jnp.asarray(f(N, P, 3) * 2.0 - 1.0),
        roughness=jnp.asarray(f(N, P)), diff_est=jnp.asarray(f(N, P, 3)),
        spec_est=jnp.asarray(f(N, P, 3)),
        view_z=jnp.asarray(f(N, P) * 30.0),
        motion=jnp.asarray(f(N, P, 2) * 8.0 - 4.0),
        pos=jnp.asarray(f(N, P, 3) * 10.0),
        dominant=jnp.asarray(rs.randint(0, P, N).astype(np.int32)),
        first_hit_t=jnp.asarray(f(N) * 10.0),
        stable_radiance=jnp.asarray(f(N, 3) * 4.0))
    prad = (jnp.asarray(f(N, P, 4) * 3.0), jnp.asarray(f(N, P, 4) * 3.0))
    pden = (jnp.asarray(f(P, H, W, 3) * 3.0), jnp.asarray(f(P, H, W, 3) * 3.0))
    den = [tuple(JRX.DenoiserState(
        radiance=jnp.asarray(f(H, W, 3)), moments=jnp.asarray(f(H, W, 2)),
        history=jnp.asarray(f(H, W) * 40.0), normal=jnp.asarray(f(H, W, 3)),
        view_z=jnp.asarray(f(H, W))) for _ in range(2)) for _ in range(P)]
    res = JRS.Reservoir(
        light=jnp.asarray(rs.randint(-2, lights, N).astype(np.int32)),
        uv=jnp.asarray(f(N, 2)), w_sum=jnp.asarray(f(N) * 2.0 + 0.1),
        m=jnp.asarray(rs.randint(1, 8, N).astype(np.float32)),
        target=jnp.asarray(f(N) + 0.1))
    gir = JGI.GIReservoir(
        pos=jnp.asarray(f(N, 3) * 10.0), normal=jnp.asarray(f(N, 3)),
        radiance=jnp.asarray(f(N, 3) * 2.0), w_sum=jnp.asarray(f(N)),
        m=jnp.asarray(f(N)), target=jnp.asarray(f(N)),
        valid=jnp.asarray(rs.rand(N) < 0.7))
    shapes = dict(motion=(H, W, 2), view_z=(H, W), roughness=(H, W),
                  gb_normal=(N, 3), gb_view_z=(N,))
    fo = JRT.FrameOutputs(**{
        name: (res if name == "reservoir" else gir if name == "gi_reservoir"
               else jnp.asarray(f(*shapes.get(name, (H, W, 3))) * 2.0))
        for name in JRT.FrameOutputs._fields})
    color = f(N, 3) * 3.0
    color[rs.rand(N) < 0.02] = np.nan
    color[rs.rand(N) < 0.01, 1] = np.inf
    ref = dict(stable_planes=sp, plane_radiance=prad, plane_denoised=pden,
               den_states=den, frame_outputs=fo, color=jnp.asarray(color))
    t = lambda a: torch.as_tensor(np.array(a))
    port = dict(
        stable_planes=interop.stable_planes_from_reference(sp, device="cpu"),
        plane_radiance=tuple(t(a) for a in prad),
        plane_denoised=tuple(t(a) for a in pden),
        den_states=[tuple(interop.denoiser_state_from_reference(
            s, device="cpu") for s in pair) for pair in den],
        frame_outputs=interop.frame_outputs_from_reference(fo, device="cpu"),
        color=t(color))
    return ref, port


@pytest.fixture(scope="module")
def seeded(art):
    return _seeded_inputs(7, int(art.ta.lights.pack.shape[0]))


@pytest.mark.parametrize("plane_index", [-1, 0, 1])
@pytest.mark.parametrize("view", PIPELINE_VIEWS)
def test_pipeline_view_matches_reference(seeded, view, plane_index):
    ref_kw, port_kw = seeded
    got = TDV.render_debug_view(view, None, None, W, H,
                                plane_index=plane_index, **port_kw).numpy()
    ref = np.asarray(JDV.render_debug_view(view, None, None, W, H,
                                           plane_index=plane_index,
                                           **ref_kw))
    assert got.shape == (H, W, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if view == "NaNSanitizer":
        assert (got == [1.0, 0.0, 1.0]).all(-1).sum() >= 7


def test_pipeline_views_refuse_missing_inputs():
    with pytest.raises(ValueError, match="stable_planes"):
        TDV.render_debug_view("StablePlaneCount", None, None, W, H)
    with pytest.raises(ValueError, match="frame_outputs"):
        TDV.render_debug_view("ReSTIRGIOutput", None, None, W, H)
    with pytest.raises(ValueError, match="color"):
        TDV.render_debug_view("NaNSanitizer", None, None, W, H)


def test_unknown_view_raises(art):
    with pytest.raises(ValueError, match="unknown debug view"):
        TDV.render_debug_view("NoSuchView", art.ta, art.tcam, W, H)


# ---- ReSTIR DI stages and ReGIR ----------------------------------------

def _flipped(got, ref):
    """Lanes whose reservoir holds another sample on the two sides."""
    return (got.light.numpy() != np.asarray(ref.light)) | ~np.isclose(
        got.uv.numpy(), np.asarray(ref.uv), rtol=RTOL_RESTIR,
        atol=ATOL_RESTIR).all(-1)


def _stage_reservoirs(art, view, port_fo, ref_fo):
    """(port, reference) reservoir the view shades."""
    if view == "ReSTIRDITemporalOutput":
        return port_fo.reservoir, ref_fo.reservoir
    base_t = TDI.generate_candidates(art.ta, art.tgb, art.px, art.py, 0)
    base_j = JDI.generate_candidates(art.jr.assets, art.jgb, art.jpx,
                                     art.jpy, 0)
    if view == "ReSTIRDIInitialOutput":
        return base_t, base_j
    if port_fo is not None:
        base_t, base_j = port_fo.reservoir, ref_fo.reservoir
    return (TDI.spatial_resample(art.ta, art.tgb, base_t, art.px, art.py, W,
                                 H, 0),
            JDI.spatial_resample(art.jr.assets, art.jgb, base_j, art.jpx,
                                 art.jpy, W, H, 0))


def test_every_view_is_held():
    assert sorted(SURFACE_VIEWS + PIPELINE_VIEWS + list(RESTIR_VIEWS)) == \
        sorted(JDV.VIEWS)


@pytest.mark.parametrize("view,with_outputs", [
    ("ReSTIRDIInitialOutput", False), ("ReSTIRDITemporalOutput", True),
    ("ReSTIRDISpatialOutput", False), ("ReSTIRDISpatialOutput", True),
    ("ReGIRIndirectOutput", False)])
def test_restir_view_matches_reference(art, seeded, view, with_outputs):
    ref_kw, port_kw = seeded
    kw = dict(port=dict(frame_outputs=port_kw["frame_outputs"]),
              ref=dict(frame_outputs=ref_kw["frame_outputs"])) \
        if with_outputs else {}
    got, ref = art.views(view, **kw)
    assert np.isfinite(got).all() and got.max() > 0.0
    if view == "ReGIRIndirectOutput":
        flipped = np.zeros(N, bool)
    else:
        flipped = _flipped(*_stage_reservoirs(
            art, view, kw.get("port", {}).get("frame_outputs"),
            kw.get("ref", {}).get("frame_outputs")))
    assert flipped.mean() <= MAX_FLIPPED, flipped.sum()
    keep = ~flipped.reshape(H, W)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=RTOL_RESTIR,
                               atol=ATOL_RESTIR)


def test_inspect_pixel_matches_reference(art):
    for x, y in ((W // 2, H // 2), (3, 2), (W - 5, H - 4)):
        got = TDV.inspect_pixel(art.ta, art.tcam, W, H, x, y)
        ref = JDV.inspect_pixel(art.jr.assets, art.jcam, W, H, x, y)
        assert set(got) == set(ref)
        for key, val in ref.items():
            if isinstance(val, (bool, int)):
                assert got[key] == val, key
                assert type(got[key]) is type(val), key
            else:
                np.testing.assert_allclose(got[key], val, rtol=1e-5,
                                           atol=1e-6, err_msg=key)
