"""Golden gate of the port on the CPU: programmer-art 64x48 2spp through
the plain versions of the kernels, against the golden the reference
rendered with XLA on the CPU (assets/golden_programmer_art_64x48_2spp.png).

Asserted: the cross-platform floor the reference holds its own
non-XLA-CPU renders to (PSNR > 40 dB, SMAPE < 0.02; the port runs other
kernels, other float code and exact winner selection). The measured value
is printed against the reference's same-platform fast gate (45 dB /
0.01)."""
import os

import numpy as np

from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.scene import envmap as EM
from rtxpt_tpu_torch.scene import procedural
from rtxpt_tpu_torch.utils import image as IM

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "golden_programmer_art_64x48_2spp.png")


def test_port_cpu_render_matches_fast_golden():
    r = Renderer(procedural.build_programmer_art().finish(),
                 procedural.default_camera(64, 48), reference_config(),
                 env_radiance=EM.bake_procedural_sky(height=64))
    img = r.tonemapped(r.render(64, 48, 2)).numpy()
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    m = IM.compare(img, IM.load_png(GOLDEN))
    print(f"port CPU 64x48 2spp vs golden: PSNR {m['psnr']:.2f} dB, "
          f"SMAPE {m['smape']:.5f} (fast gate 45 dB / 0.01)")
    assert m["psnr"] > 40.0, m
    assert m["smape"] < 0.02, m


def test_tonemap_and_accumulation_match_reference():
    """Auto-exposed ACES tone mapping and the running-mean accumulation
    against the reference on the same HDR samples (float32 rounding of
    log2/exp2/pow: rtol 1e-5)."""
    import jax.numpy as jnp
    import torch
    from rtxpt_tpu.post import accumulation as JA
    from rtxpt_tpu.post import tonemap as JT
    from rtxpt_tpu_torch.post import accumulation as TA
    from rtxpt_tpu_torch.post import tonemap as TT

    r = np.random.RandomState(0)
    samples = (r.lognormal(-1.0, 1.5, (3, 24, 32, 3))).astype(np.float32)
    j_acc = jnp.zeros((24, 32, 3), jnp.float32)
    t_acc = torch.zeros((24, 32, 3))
    for i, s in enumerate(samples):
        j_acc = JA.accumulate(j_acc, jnp.asarray(s), i)
        t_acc = TA.accumulate(t_acc, torch.as_tensor(s), i)
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc), rtol=1e-6)
    for auto in (False, True):
        ref = np.asarray(JT.tonemap(j_acc, exposure=1.5, auto_expose=auto))
        got = TT.tonemap(t_acc, exposure=1.5, auto_expose=auto).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
