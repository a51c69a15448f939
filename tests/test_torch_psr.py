"""PSR-lite, the realtime mode's single-plane pipeline
(use_stable_planes=False), against the reference package on the CPU.

`trace_gbuffer` (rtxpt_tpu_torch/pt/gbuffer.py) on programmer-art at
64x48, with psr_depth 0 (the camera hit alone) and 2 (two segments of the
delta chain of the mirror and glass spheres), on the reference's tables
and on the port's own build: `valid` and `prim` equal, the float fields
(the surface data included) within rtol 2e-4 / atol 5e-5. The reference's
dense trace runs in interpret mode, as its own CPU tests do.

Whole PSR-lite frames 1 and 2 at 16x12 (max_bounces 3, the reach-masked
comparison of tests/realtime_compare.py) for two pipelines: ReSTIR DI +
GI with ReLAX and TAA (the fused final shade), and the ref-vs-realtime
preset. tests/test_torch_psr_restir.py holds the DI-only and GI-only
pipelines."""
from collections import namedtuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_compare import (compare_frames, port_renderer,
                              reference_frames)
from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import realtime_config as j_realtime_config
from rtxpt_tpu.pt import gbuffer as JGB
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.models.renderer import Renderer, realtime_config
from rtxpt_tpu_torch.pt import gbuffer as TGB
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import procedural as TP

GW, GH = 64, 48
DEPTHS = (0, 2)
INTS = ("valid", "prim", "interior", "front_facing", "material_id",
        "thin_surface", "nested_priority", "alpha_mode", "double_sided")
PIPELINES = {
    "di-gi-relax-taa": dict(
        cfg=dict(use_restir_di=True, use_restir_gi=True,
                 denoiser_enabled=True, use_stable_planes=False,
                 max_bounces=3),
        frame=dict()),
    "ref-vs-realtime": dict(
        cfg=dict(use_restir_di=False, use_restir_gi=False,
                 denoiser_enabled=False, realtime_noise=False,
                 use_stable_planes=False, max_bounces=3,
                 nee_distant_samples=1, nee_local_samples=1,
                 enable_russian_roulette=False),
        frame=dict(denoise=False, taa=False)),
}


def _flat(gb, prefix=""):
    """{field path: numpy array} of a GBuffer and its SurfaceData."""
    out = {}
    for name, val in gb._asdict().items():
        if isinstance(val, tuple):
            out.update(_flat(val, prefix + name + "."))
        else:
            out[prefix + name] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def gbuffers():
    """({depth: reference G-buffer fields}, the reference renderer)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTXPT_DENSE_INTERPRET", "1")
        jr = JRenderer(JP.build_programmer_art().finish(),
                       JP.default_camera(GW, GH), j_realtime_config(),
                       env_radiance=JEM.bake_procedural_sky(height=32))
        jcam = jr.camera._replace(jitter=jnp.zeros(2), viewport=jnp.asarray(
            [GW, GH], jnp.float32))
        px, py = jr._pixel_grid(GW, GH)
        ref = {d: _flat(JGB.trace_gbuffer(jr.assets, jcam, jcam, px, py,
                                          psr_depth=d)) for d in DEPTHS}
    return ref, jr


def _port_gbuffer(jr, tables: str, depth: int):
    r = Renderer(TP.build_programmer_art().finish(),
                 TP.default_camera(GW, GH), realtime_config(),
                 env_radiance=TEM.bake_procedural_sky(height=32),
                 device="cpu")
    if tables == "shared":
        r.assets = interop.assets_from_reference(jr.scene, jr.dense, jr.env,
                                                 jr.lights, device="cpu")
    cam = r._camera(GW, GH, (0.0, 0.0))
    px, py = r._pixel_grid(GW, GH)
    return TGB.trace_gbuffer(r.assets, cam, cam, px, py, psr_depth=depth)


@pytest.mark.parametrize("tables", ["shared", "own"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_trace_gbuffer_matches_reference(gbuffers, depth, tables):
    ref, jr = gbuffers
    got = _flat(_port_gbuffer(jr, tables, depth))
    want = ref[depth]
    assert set(got) == set(want)
    for name, val in got.items():
        assert val.shape == want[name].shape, name
        if name.split(".")[-1] in INTS:
            np.testing.assert_array_equal(val, want[name].astype(val.dtype),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(val, want[name], rtol=2e-4,
                                       atol=5e-5, err_msg=name)


def test_gbuffer_from_reference_round_trips(gbuffers):
    """interop.gbuffer_from_reference keeps every field and dtype."""
    ref, jr = gbuffers
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTXPT_DENSE_INTERPRET", "1")
        jcam = jr.camera._replace(jitter=jnp.zeros(2), viewport=jnp.asarray(
            [GW, GH], jnp.float32))
        px, py = jr._pixel_grid(GW, GH)
        jgb = JGB.trace_gbuffer(jr.assets, jcam, jcam, px, py, psr_depth=0)
    gb = interop.gbuffer_from_reference(jgb, device="cpu")
    assert gb.prim.dtype == torch.int32 and gb.valid.dtype == torch.bool
    assert gb.surface.sd.thin_surface.dtype == torch.bool
    for name, val in _flat(gb).items():
        np.testing.assert_array_equal(val, ref[0][name].astype(val.dtype),
                                      err_msg=name)


def test_psr_replaces_mirror_surface():
    """tests/test_psr.py's properties on the port: the mirror and glass
    spheres chain, chained pixels land on another surface, the others keep
    theirs, and the chain's throughput stays in [0, 1]."""
    r = Renderer(TP.build_programmer_art().finish(),
                 TP.default_camera(GW, GH), realtime_config(),
                 env_radiance=TEM.bake_procedural_sky(height=32),
                 device="cpu")
    cam = r._camera(GW, GH, (0.0, 0.0))
    px, py = r._pixel_grid(GW, GH)
    gb0 = TGB.trace_gbuffer(r.assets, cam, cam, px, py, psr_depth=0)
    gb2 = TGB.trace_gbuffer(r.assets, cam, cam, px, py, psr_depth=2)
    thp = gb2.psr_thp.numpy()
    moved = (thp < 0.999).any(-1)
    assert moved.sum() > 20
    changed = np.linalg.norm(gb0.pos.numpy() - gb2.pos.numpy(), axis=-1) \
        > 1e-3
    assert changed[moved].mean() > 0.9
    np.testing.assert_allclose(gb2.pos.numpy()[~moved],
                               gb0.pos.numpy()[~moved], atol=1e-5)
    assert (thp >= 0).all() and (thp <= 1.001).all()


def test_select_keeps_dtypes():
    """gbuffer.select picks per lane through nested NamedTuples, integer
    and bool fields included, the mask broadcast over trailing dims."""
    Pair = namedtuple("Pair", "a inner")
    Inner = namedtuple("Inner", "i b")
    mask = torch.tensor([True, False, True])
    x = Pair(torch.ones(3, 2), Inner(torch.full((3,), 7, dtype=torch.int64),
                                     torch.ones(3, dtype=torch.bool)))
    y = Pair(torch.zeros(3, 2), Inner(torch.zeros(3, dtype=torch.int64),
                                      torch.zeros(3, dtype=torch.bool)))
    s = TGB.select(mask, x, y)
    assert s.a.tolist() == [[1, 1], [0, 0], [1, 1]]
    assert s.inner.i.dtype == torch.int64 and s.inner.i.tolist() == [7, 0, 7]
    assert s.inner.b.tolist() == [True, False, True]


@pytest.fixture(scope="module", params=sorted(PIPELINES))
def reference(request):
    """(pipeline name, reference renderer, its frames and states)."""
    p = PIPELINES[request.param]
    jr, frames = reference_frames(p["cfg"], p["frame"])
    return request.param, jr, frames


@pytest.mark.parametrize("tables", ["own", "shared"])
def test_psr_frames_match_reference(reference, tables, record_property):
    name, jr, frames = reference
    p = PIPELINES[name]
    r = port_renderer(jr, p["cfg"], tables)
    compare_frames(r, frames, p["frame"], record_property)
    assert r.last_outputs is not None and r.last_stable_planes is None
    if name == "di-gi-relax-taa":
        # frame 2 reused frame 1's reservoirs and histories
        assert float(r.prev_reservoir.m.max()) > 8.0
        assert r.taa_state.valid
        assert float(r.den_diff.history.max()) >= 2.0
