"""The textured, alpha-MASK slice end to end in reference mode: the scene
of tests/textured_scene.py (a floor, alpha-MASK leaf cards with 64x64
textures, a BLEND card, a normal-mapped box and an emitter) at 16x12,
reference_config(max_bounces=3), through the reference's Renderer (dense
trace in interpret mode with its OMM channel, the chain of XLA ops) and
the port's on the CPU: HDR rtol 2e-4 / atol 5e-5, as
tests/reference_configs.py. The port's render runs the texture taps at
ray-cone LODs, the OMM channel of the dense trace's plain version and the
exact alpha re-queue of its NEE rays."""
import numpy as np

import textured_scene as TS
from reference_configs import ATOL, RTOL, reference_env
from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import reference_config as j_config
from rtxpt_tpu.scene import build as JB
from rtxpt_tpu.scene import camera as JC
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.scene import build as TB
from rtxpt_tpu_torch.scene import camera as TC
from rtxpt_tpu_torch.scene import envmap as TEM

SPP = 2


def test_textured_scene_builds_alike():
    ref, got = TS.build(JB.SceneBuilder, JB.Mesh), TS.build(TB.SceneBuilder,
                                                            TB.Mesh)
    for k in ("positions", "normals", "tangents", "uvs", "indices",
              "tri_mat"):
        assert np.array_equal(got[k], ref[k]), k
    for k, v in ref["materials"].items():
        assert np.array_equal(got["materials"][k], v), k


def test_textured_render_matches_reference(monkeypatch):
    reference_env(monkeypatch)
    jr = JRenderer(TS.build(JB.SceneBuilder, JB.Mesh), TS.camera(JC),
                   j_config(max_bounces=3),
                   env_radiance=JEM.bake_procedural_sky(height=32))
    assert jr.cfg.exact_alpha_test and jr.dense.has_omm
    ref = np.asarray(jr.render(TS.W, TS.H, SPP))
    r = Renderer(TS.build(TB.SceneBuilder, TB.Mesh), TS.camera(TC),
                 reference_config(max_bounces=3),
                 env_radiance=TEM.bake_procedural_sky(height=32),
                 device="cpu")
    assert r.cfg.exact_alpha_test and r.accel.has_omm
    assert r.scene.textures is not None
    cuda_lib.reset_launch_counts()
    got = r.render(TS.W, TS.H, SPP).numpy()
    assert not any(cuda_lib.launch_counts().values())
    assert got.shape == ref.shape == (TS.H, TS.W, 3)
    assert np.isfinite(got).all() and got.mean() > 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
