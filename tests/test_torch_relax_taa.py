"""ReLAX (rtxpt_tpu_torch/denoise/relax.py) and TAA (post/taa.py) against
the reference package on the CPU, over two frames.

Inputs come from a seed with numpy: noisy radiance, a normal field with a
crease, a depth field with a step (so the edge-stopping weights cut), and
sub-pixel motion (so the history fetches interpolate). Frame 1 starts
without history; frame 2 takes the reference's frame-1 state, converted by
`interop`, so each frame is held on identical inputs. The filters are
float32 stencils that both packages evaluate in the same order:
tolerance rtol 1e-5 / atol 1e-6."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.denoise import relax as JRX
from rtxpt_tpu.post import taa as JTAA
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.denoise import relax as TRX
from rtxpt_tpu_torch.post import taa as TTAA

H, W = 20, 28
RTOL, ATOL = 1e-5, 1e-6


def _frame(seed):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    rad = (rs.gamma(1.0, 1.0, (H, W, 3))
           * (1.0 + (xx > W / 2))[..., None]).astype(np.float32)
    nrm = np.stack([np.where(xx > W / 3, 0.6, 0.0), 0.1 * np.sin(yy),
                    np.ones_like(xx)], -1)
    nrm = (nrm + 0.02 * rs.normal(size=nrm.shape))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)) \
        .astype(np.float32)
    z = (4.0 + 0.05 * yy + np.where(yy > H / 2, 3.0, 0.0)).astype(np.float32)
    motion = rs.uniform(-1.5, 1.5, (H, W, 2)).astype(np.float32)
    rough = rs.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    return rad, nrm, z, motion, rough


def _close(got, ref, name=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=name)


@pytest.mark.parametrize("channel", ["diffuse", "specular"])
def test_relax_denoise_two_frames(channel):
    """Diffuse: 4 a-trous iterations, no roughness; specular: 3 with the
    roughness-aware weights (the realtime pipeline's two channels)."""
    j_state = t_state = None
    for frame in range(2):
        rad, nrm, z, motion, rough = _frame(frame)
        kw = dict(iterations=4) if channel == "diffuse" else dict(
            iterations=3)
        ref, j_state = JRX.denoise(
            j_state, jnp.asarray(rad), jnp.asarray(nrm), jnp.asarray(z),
            jnp.asarray(motion),
            roughness=None if channel == "diffuse" else jnp.asarray(rough),
            **kw)
        got, t_state = TRX.denoise(
            t_state, torch.as_tensor(rad), torch.as_tensor(nrm),
            torch.as_tensor(z), torch.as_tensor(motion),
            roughness=None if channel == "diffuse" else torch.as_tensor(
                rough), **kw)
        _close(got, ref, f"frame {frame}")
        for f in TRX.DenoiserState._fields:
            _close(getattr(t_state, f), getattr(j_state, f), f)
        # the next frame starts from the reference's state
        t_state = interop.denoiser_state_from_reference(j_state, "cpu")
    assert float(t_state.history.max()) >= 2.0


def test_taa_resolve_two_frames():
    """Frame 1 passes the colour through and starts the history; frame 2
    fetches it (Catmull-Rom), clips it to the 3x3 neighbourhood and
    blends, with and without the denoiser's relax mask."""
    j_state = t_state = None
    for frame in range(2):
        color, _, _, motion, rough = _frame(10 + frame)
        for mask in (None, rough):
            ref, j_new = JTAA.resolve(
                j_state, jnp.asarray(color), jnp.asarray(motion),
                relax_mask=None if mask is None else jnp.asarray(mask))
            got, t_new = TTAA.resolve(
                t_state, torch.as_tensor(color), torch.as_tensor(motion),
                relax_mask=None if mask is None else torch.as_tensor(mask))
            _close(got, ref, f"frame {frame}")
            _close(t_new.history, j_new.history, "history")
            assert t_new.valid == bool(j_new.valid)
        if frame == 1:
            assert not np.allclose(got.numpy(), color)
        j_state = j_new
        t_state = interop.taa_state_from_reference(j_state, "cpu")
