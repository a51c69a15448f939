"""Wavefront sort modes of the port's bounce loop (rtxpt_tpu_torch/pt/
integrator.py `wavefront_sort_key`, `sort_bounds`; core/mathutils.py
`morton3d`) against the reference's keys (rtxpt_tpu/pt/integrator.py
:1053-1110, evaluated here on the same inputs), and the sorted renders
against the unsorted one: a sort permutes lanes and changes no lane's
math, so the image must match to the tolerance of the reference's own
oracle, tests/test_raystream_sort.py (rtol 1e-5, atol 1e-6)."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.core import mathutils as jmu
from rtxpt_tpu.ops.intersect import TriSoup
from rtxpt_tpu_torch.core import mathutils as mu
from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.pt import integrator as I
from rtxpt_tpu_torch.scene import envmap as EM
from rtxpt_tpu_torch.scene import procedural


def _ref_key(mode, active, direction, material_id, new_o, new_d, new_act,
             lo, hi):
    """The reference's sort key expressions, verbatim in jnp."""
    if mode == "octant":
        octant = ((direction[..., 0] < 0).astype(jnp.int32)
                  + 2 * (direction[..., 1] < 0).astype(jnp.int32)
                  + 4 * (direction[..., 2] < 0).astype(jnp.int32))
        return jnp.where(active, octant, 8)
    if mode == "raystream":
        scale = 31.999 / jnp.maximum(hi - lo, 1e-6)
        q = jnp.clip((new_o - lo) * scale, 0.0, 31.999).astype(jnp.uint32)
        octant = ((new_d[..., 0] < 0).astype(jnp.uint32)
                  + 2 * (new_d[..., 1] < 0).astype(jnp.uint32)
                  + 4 * (new_d[..., 2] < 0).astype(jnp.uint32))
        key = (jmu.morton3d(q[..., 0], q[..., 1], q[..., 2])
               * jnp.uint32(8) + octant).astype(jnp.int32)
        return jnp.where(new_act, key, jnp.int32(1 << 30))
    return jnp.where(active, material_id.astype(jnp.int32),
                     jnp.int32(1 << 30))


@pytest.fixture(scope="module")
def art():
    return procedural.build_programmer_art().finish()


def test_morton3d_matches_reference():
    q = np.random.RandomState(0).randint(0, 1024, (3, 4096)).astype(np.uint32)
    ref = np.asarray(jmu.morton3d(*(jnp.asarray(a) for a in q)))
    got = mu.morton3d(*(torch.as_tensor(a.astype(np.int64)) for a in q))
    assert np.array_equal(got.numpy(), ref.astype(np.int64))


def test_sort_bounds_match_reference(art):
    pos, idx = art["positions"], art["indices"]
    dense = Renderer(art, procedural.default_camera(8, 6), device="cpu")
    lo, hi = I.sort_bounds(dense.assets)
    aabb = np.asarray(dense.accel.aabb)
    assert np.array_equal(lo.numpy(), aabb[:, 0:3].min(0))
    assert np.array_equal(hi.numpy(), aabb[:, 3:6].max(0))
    # the BVH tiers: the reference's soup bounds
    v = TriSoup.build(pos, idx).verts
    p0 = v[:, 0:3]
    j_lo = jnp.min(jnp.minimum(p0, jnp.minimum(p0 + v[:, 3:6],
                                               p0 + v[:, 6:9])), axis=0)
    j_hi = jnp.max(jnp.maximum(p0, jnp.maximum(p0 + v[:, 3:6],
                                               p0 + v[:, 6:9])), axis=0)
    soup = types.SimpleNamespace(
        accel=None, scene=types.SimpleNamespace(
            positions=torch.as_tensor(pos), indices=torch.as_tensor(idx)))
    lo, hi = I.sort_bounds(soup)
    assert np.array_equal(lo.numpy(), np.asarray(j_lo))
    assert np.array_equal(hi.numpy(), np.asarray(j_hi))


@pytest.mark.parametrize("mode", ["octant", "raystream", "material"])
def test_sort_keys_match_reference(mode):
    r = np.random.RandomState(5)
    n = 3000
    lo = np.array([-6.0, -0.5, -4.0], np.float32)
    hi = np.array([5.0, 7.5, 6.0], np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[r.rand(n, 3) < 0.1] = -0.0
    new_d = r.normal(size=(n, 3)).astype(np.float32)
    new_o = r.uniform(lo - 1.0, hi + 1.0, (n, 3)).astype(np.float32)
    act, new_act = r.rand(n) < 0.7, r.rand(n) < 0.7
    mat = r.randint(0, 40, n).astype(np.int32)
    path = types.SimpleNamespace(origin=torch.as_tensor(new_o),
                                 direction=torch.as_tensor(new_d),
                                 active=torch.as_tensor(new_act))
    got = I.wavefront_sort_key(mode, torch.as_tensor(act),
                               torch.as_tensor(d), torch.as_tensor(mat), path,
                               (torch.as_tensor(lo), torch.as_tensor(hi)))
    ref = _ref_key(mode, *(jnp.asarray(a) for a in (
        act, d, mat, new_o, new_d, new_act, lo, hi)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    assert len(np.unique(got.numpy())) > (8 if mode == "octant" else 30)


def test_unknown_sort_mode_raises(art):
    cfg = reference_config(max_bounces=1, wavefront_sort="hilbert")
    r = Renderer(art, procedural.default_camera(4, 3), cfg, device="cpu")
    with pytest.raises(ValueError):
        r.render(4, 3, 1)


@pytest.fixture(scope="module")
def renders(art):
    """16x12 renders, 2 spp (one regenerating wavefront) and 1 spp, under
    each sort mode, as the reference's oracle configures them."""
    w, h = 16, 12
    base = dataclasses.replace(
        reference_config(max_bounces=4, max_diffuse_bounces=3,
                         nee_distant_samples=1, nee_local_samples=1),
        wavefront_compaction=False)
    r = Renderer(art, procedural.default_camera(w, h), base,
                 env_radiance=EM.bake_procedural_sky(height=32), device="cpu")
    out = {}
    for mode in ("none", "octant", "raystream", "material"):
        r.cfg = dataclasses.replace(base, wavefront_sort=mode)
        for spp in (2, 1):
            r.reset_accumulation()
            out[mode, spp] = r.render(w, h, spp).numpy()
    return out


@pytest.mark.parametrize("mode", ["octant", "raystream", "material"])
@pytest.mark.parametrize("spp", [2, 1])
def test_sorted_render_equals_unsorted(renders, mode, spp):
    got, ref = renders[mode, spp], renders["none", spp]
    assert np.isfinite(got).all() and ref.mean() > 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
