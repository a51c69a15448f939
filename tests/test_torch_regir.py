"""Local-light sampling off the fused pass: `lights.sample_local_lights`
(the power sampler) and ReGIR (restir/regir.py, grid and onion cells)
against the reference's on the reference's light table and seeded
uniforms, and renders with ReGIR local sampling against the reference's
(tests/reference_configs.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_configs import assert_matches, render_pair
from rtxpt_tpu.restir import regir as JRG
from rtxpt_tpu.scene import lights as JLI
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.restir import regir as TRG
from rtxpt_tpu_torch.scene import lights as TLI

ANALYTIC = [
    dict(kind=JLI.LIGHT_POINT, position=(1.0, 3.0, 0.5),
         radiance=(5.0, 4.0, 3.0)),
    dict(kind=JLI.LIGHT_SPOT, position=(-1.0, 2.5, 1.0),
         radiance=(8.0, 8.0, 6.0), axis=(0.2, -1.0, 0.1),
         outer_angle=0.6, inner_angle=0.3),
    dict(kind=JLI.LIGHT_SPHERE, position=(0.5, 2.0, -1.0), radius=0.2,
         radiance=(3.0, 2.0, 1.0)),
    dict(kind=JLI.LIGHT_DIRECTIONAL, direction=(0.3, -1.0, 0.2),
         radiance=(2.0, 2.0, 2.0)),
]
CONFIGS = {"grid": (1, dict(nee_local_type=2)),
           "onion": (1, dict(nee_local_type=2, regir_layout="onion"))}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_regir_render_matches_reference(monkeypatch, name):
    spp, cfg = CONFIGS[name]
    assert_matches(*render_pair(monkeypatch, spp, **cfg))


def _tables(analytic=None):
    """(host scene, reference light table, the port's copy of it)."""
    host = JP.build_programmer_art().finish()
    jl = JLI.build_light_table(host, analytic)
    tl = interop.lights_from_arrays(pack=jl.pack, cdf=jl.cdf,
                                    total_power=jl.total_power, device="cpu")
    return host, jl, tl


def _points(host, n, seed):
    r = np.random.RandomState(seed)
    lo, hi = host["positions"].min(0), host["positions"].max(0)
    return (lo + r.rand(n, 3) * (hi - lo)).astype(np.float32)


def _close(ref, got, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def test_sample_local_lights_matches_reference():
    host, jl, tl = _tables(ANALYTIC)
    n = 4096
    pos = _points(host, n, 1)
    u3 = np.random.RandomState(2).rand(n, 3).astype(np.float32)
    js = JLI.sample_local_lights(jl, None, None, jnp.asarray(pos),
                                 jnp.asarray(u3))
    ts = TLI.sample_local_lights(tl, torch.as_tensor(pos),
                                 torch.as_tensor(u3))
    assert np.array_equal(np.asarray(js.valid), ts.valid.numpy())
    assert np.array_equal(np.asarray(js.delta), ts.delta.numpy())
    assert ts.delta.any() and (~ts.delta).any() and ts.valid.any()
    for field in ("direction", "distance", "li", "pdf"):
        _close(getattr(js, field), getattr(ts, field))


@pytest.mark.parametrize("layout", ["grid", "onion"])
def test_regir_matches_reference(layout):
    host, jl, tl = _tables(ANALYTIC)
    lo = host["positions"].min(0) - 1e-3
    hi = host["positions"].max(0) + 1e-3
    center = np.asarray([0.3, 1.2, 4.0], np.float32)
    jg = JRG.build_regir(jl, None, None, jnp.asarray(lo), jnp.asarray(hi), 3,
                         layout=layout, center=jnp.asarray(center))
    tg = TRG.build_regir(tl, torch.as_tensor(lo), torch.as_tensor(hi), 3,
                         layout=layout, center=torch.as_tensor(center))
    assert np.array_equal(np.asarray(jg.light), tg.light.numpy())
    _close(jg.uv, tg.uv)
    _close(jg.w, tg.w)
    assert (tg.w > 0).float().mean() > 0.3     # most cells see a light
    _close(jg.grid_lo, tg.grid_lo)
    _close(jg.grid_inv_ext, tg.grid_inv_ext)
    n = 4096
    pos = _points(host, n, 4)
    u2 = np.random.RandomState(5).rand(n, 2).astype(np.float32)
    js = JRG.sample_regir(jg, jl, None, None, jnp.asarray(pos),
                          jnp.asarray(u2))
    ts = TRG.sample_regir(tg, tl, torch.as_tensor(pos), torch.as_tensor(u2))
    assert np.array_equal(np.asarray(js.valid), ts.valid.numpy())
    assert np.array_equal(np.asarray(js.delta), ts.delta.numpy())
    assert ts.valid.float().mean() > 0.3
    for field in ("direction", "distance", "li", "pdf"):
        _close(getattr(js, field), getattr(ts, field))


def test_regir_refuses_unknown_layout():
    _, _, tl = _tables()
    with pytest.raises(ValueError, match="layout"):
        TRG.build_regir(tl, torch.zeros(3), torch.ones(3), 0,
                        layout="cubes")
