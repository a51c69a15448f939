"""Surface loading and nested dielectrics against the reference.

load_surface: the port fetches rows with its gather kernels (K2/K3) and
takes face normals from the per-triangle table; the reference on CPU
gathers raw vertex rows and recomputes the face normal, so the two agree
to float32 rounding (rtol 1e-5 / atol 1e-6). The nested-dielectric stack
is integer bookkeeping: bit-exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.pt import nested as JN
from rtxpt_tpu.pt import shading as JS
from rtxpt_tpu.scene import build as JB
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.pt import nested as TN
from rtxpt_tpu_torch.pt import shading as TS

N = 2000


@pytest.fixture(scope="module")
def scenes():
    js = JB.to_device(JP.build_programmer_art().finish())
    ts = interop.scene_from_arrays(
        positions=js.positions, indices=js.indices, vert_pack=js.vert_pack,
        tri_pack=js.tri_pack, tri_geom_pack=js.tri_geom_pack,
        mat_pack=js.mat_pack, material_ior=js.materials.ior,
        volume_absorption=js.materials.volume_absorption, device="cpu")
    return js, ts


def _hits(seed, n_tris):
    r = np.random.RandomState(seed)
    prim = r.randint(0, n_tris, N).astype(np.int32)
    bary = r.dirichlet([1.0, 1.0, 1.0], N)[:, 1:].astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ior = np.where(r.rand(N) < 0.3, 1.5, 1.0).astype(np.float32)
    return prim, bary, d, ior


def _flat(x):
    if isinstance(x, tuple):
        out = {}
        for name, v in zip(x._fields, x):
            out.update({f"{name}.{k}": w for k, w in _flat(v).items()})
        return out
    return {"": x}


@pytest.mark.parametrize("seed", [0, 1])
def test_load_surface_matches_reference(scenes, seed):
    js, ts = scenes
    prim, bary, d, ior = _hits(seed, ts.num_triangles)
    ref = JS.load_surface(js, jnp.asarray(prim), jnp.asarray(bary),
                          jnp.asarray(d))
    ref = JS.update_outside_ior(ref, jnp.asarray(ior))
    got = TS.load_surface(ts, torch.as_tensor(prim), torch.as_tensor(bary),
                          torch.as_tensor(d))
    got = TS.update_outside_ior(got, torch.as_tensor(ior))
    want = {k: np.asarray(v) for k, v in _flat(ref).items()}
    have = {k: v.numpy() for k, v in _flat(got).items()}
    assert set(have) <= set(want)
    for key, v in have.items():
        r = want[key]
        if v.dtype == bool or np.issubdtype(v.dtype, np.integer):
            assert np.array_equal(v, r.astype(v.dtype)), key
        else:
            np.testing.assert_allclose(v, r, rtol=1e-5, atol=1e-6,
                                       err_msg=key)


def test_nested_stack_bit_exact():
    r = np.random.RandomState(5)
    slots = np.zeros((N, 2), np.uint32)
    for _ in range(6):     # random sequences of entries and exits
        mid = r.randint(0, 9, N).astype(np.int32)
        prio = r.randint(0, 15, N).astype(np.int32)
        entering = r.rand(N) < 0.6
        ref = np.asarray(JN.handle_intersection(
            jnp.asarray(slots), jnp.asarray(mid), jnp.asarray(prio),
            jnp.asarray(entering)))
        got = TN.handle_intersection(
            torch.as_tensor(slots.astype(np.int64)), torch.as_tensor(mid),
            torch.as_tensor(prio), torch.as_tensor(entering)).numpy()
        assert np.array_equal(got, ref.astype(np.int64))
        iors = np.linspace(1.0, 1.8, 9).astype(np.float32)
        for fn in ("is_true_intersection",):
            assert np.array_equal(
                np.asarray(getattr(JN, fn)(jnp.asarray(slots),
                                           jnp.asarray(prio))),
                getattr(TN, fn)(torch.as_tensor(slots.astype(np.int64)),
                                torch.as_tensor(prio)).numpy())
        assert np.array_equal(
            np.asarray(JN.compute_outside_ior(
                jnp.asarray(slots), jnp.asarray(mid), jnp.asarray(entering),
                jnp.asarray(iors))),
            TN.compute_outside_ior(
                torch.as_tensor(slots.astype(np.int64)),
                torch.as_tensor(mid), torch.as_tensor(entering),
                torch.as_tensor(iors)).numpy())
        slots = ref
