"""The surface fetch (rtxpt_tpu_torch/ops/gather.py `gather_surface`, K2 +
K3 in one launch) on CPU tensors.

Against the reference's four fetches on the same tables: the triangle,
geometry and material rows are the reference's XLA gathers (exact, with
the index clamped at 0 as `load_surface`'s callers clamp it), and the
blended vertex rows are its Pallas K3 in interpret mode, whose bf16
residual planes carry the full float32 mantissa (rtol/atol 2e-6, as in
tests/test_torch_gather.py). Against the port's own chain of plain
gathers: bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.ops import gather_pallas as GPL
from rtxpt_tpu_torch.ops import cuda_lib, gather
from rtxpt_tpu_torch.scene import build as TB
from rtxpt_tpu_torch.scene import procedural

# lane counts that are no multiple of a tile (256, 512 or 1024 lanes)
LANES = (1, 127, 1543)


def _random_tables(seed, n_tris=300, n_verts=500, n_mats=20):
    """Scene tables whose tri_pack names materials up to n_mats + 5 (some
    beyond mat_pack) and vertices within vert_pack."""
    r = np.random.RandomState(seed)
    tri_pack = np.concatenate(
        [r.randint(0, n_verts, (n_tris, 3)),
         r.randint(0, n_mats + 5, (n_tris, 1))], 1).astype(np.int32)
    vert_pack = (r.normal(size=(n_verts, 12)) * 4.0).astype(np.float32)
    tri_geom = r.normal(size=(n_tris, 5)).astype(np.float32)
    mat_pack = r.uniform(0.0, 2.0, (n_mats, 46)).astype(np.float32)
    return tri_pack, vert_pack, tri_geom, mat_pack


def _art_tables():
    s = TB.to_device(procedural.build_programmer_art().finish(), "cpu")
    return tuple(t.numpy() for t in (s.tri_pack, s.vert_pack,
                                     s.tri_geom_pack, s.mat_pack))


def _tables(source):
    return _random_tables(3) if source == "random" else _art_tables()


def _hits(seed, n, n_tris):
    """prim with misses (-1) and ids beyond the table; barycentrics."""
    r = np.random.RandomState(seed)
    prim = r.randint(0, n_tris, n).astype(np.int32)
    prim[r.rand(n) < 0.1] = -1
    prim[r.rand(n) < 0.05] = n_tris + 7
    bary = r.dirichlet([1.0, 1.0, 1.0], n)[:, 1:].astype(np.float32)
    return prim, bary


def _torch(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("source", ["random", "programmer-art"])
def test_gather_surface_matches_reference_fetches(source, n):
    tables = _tables(source)
    tri_pack, vert_pack, tri_geom, mat_pack = tables
    prim, bary = _hits(n, n, tri_pack.shape[0])
    vi, geom, mrow, mid = gather.gather_surface(*_torch(*tables, prim, bary))
    assert (vi.shape, geom.shape, mrow.shape, mid.shape) == (
        (n, 12), (n, 5), (n, 46), (n,))
    assert mid.dtype == torch.int32

    p = jnp.maximum(jnp.asarray(prim), 0)
    tp = np.asarray(jnp.asarray(tri_pack)[p])
    assert np.array_equal(mid.numpy(), tp[:, 3])
    assert np.array_equal(geom.numpy(), np.asarray(jnp.asarray(tri_geom)[p]))
    assert np.array_equal(mrow.numpy(),
                          np.asarray(jnp.asarray(mat_pack)[tp[:, 3]]))
    b = jnp.asarray(bary)
    w = jnp.stack([1.0 - b[:, 0] - b[:, 1], b[:, 0], b[:, 1]], axis=-1)
    ref = np.asarray(GPL.gather_rows_interp(
        GPL.pack_f32(vert_pack), jnp.asarray(tp[:, :3]), w, interpret=True))
    np.testing.assert_allclose(vi.numpy(), ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("source", ["random", "programmer-art"])
def test_gather_surface_bit_equal_to_plain_chain(source, n):
    tables = _torch(*_tables(source))
    tri_pack, vert_pack, tri_geom, mat_pack = tables
    prim, bary = _torch(*_hits(n + 1, n, tri_pack.shape[0]))
    got = gather.gather_surface(*tables, prim, bary)
    # load_surface's chain before the surface fetch: K2, K3, K2, K2
    p = torch.clamp(prim, min=0)
    tp = gather.gather_rows_plain(tri_pack, p)
    w = torch.stack([1.0 - bary[:, 0] - bary[:, 1], bary[:, 0], bary[:, 1]],
                    dim=-1)
    want = (gather.gather_rows_interp_plain(vert_pack, tp[:, :3], w),
            gather.gather_rows_plain(tri_geom, p),
            gather.gather_rows_plain(mat_pack, tp[:, 3]), tp[:, 3])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_gather_surface_clamps_rows():
    tri_pack, vert_pack, tri_geom, mat_pack = _random_tables(5)
    tri_pack[0, 3], tri_pack[299, 3] = 24, 20   # beyond mat_pack's 20 rows
    prim = np.array([-1, -9, 0, 299, 300, 10_000], dtype=np.int32)
    bary = np.full((6, 2), 0.25, np.float32)
    vi, geom, mrow, mid = gather.gather_surface(
        *_torch(tri_pack, vert_pack, tri_geom, mat_pack, prim, bary))
    p = np.clip(prim, 0, 299)
    assert np.array_equal(geom.numpy(), tri_geom[p])
    assert np.array_equal(mid.numpy(), tri_pack[p, 3])
    assert np.array_equal(mid.numpy(), [24, 24, 24, 20, 20, 20])
    assert np.array_equal(mrow.numpy(),
                          mat_pack[np.clip(tri_pack[p, 3], 0, 19)])


def test_gather_surface_no_lanes():
    tables = _torch(*_random_tables(6))
    vi, geom, mrow, mid = gather.gather_surface(
        *tables, torch.zeros(0, dtype=torch.int32), torch.zeros((0, 2)))
    assert (vi.shape, geom.shape, mrow.shape, mid.shape) == (
        (0, 12), (0, 5), (0, 46), (0,))


def test_gather_surface_cpu_counts_no_launch():
    tables = _torch(*_random_tables(7))
    prim, bary = _torch(*_hits(7, 64, 300))
    cuda_lib.reset_launch_counts()
    gather.gather_surface(*tables, prim, bary)
    counts = cuda_lib.launch_counts()
    assert counts["gather_surface"] == 0, counts
    assert counts["gather_rows"] == counts["gather_rows_interp"] == 0, counts


def _bad(case, tables, prim, bary):
    tri_pack, vert_pack, tri_geom, mat_pack = tables
    if case == "table dtype":
        tri_pack = tri_pack.to(torch.int64)
    elif case == "table width":
        vert_pack = vert_pack[:, :11].contiguous()
    elif case == "non-contiguous table":
        mat_pack = torch.cat([mat_pack, mat_pack], 1)[:, ::2]
    elif case == "row counts":
        tri_geom = tri_geom[:-1]
    elif case == "empty table":
        mat_pack = mat_pack[:0]
    elif case == "prim dtype":
        prim = prim.float()
    elif case == "prim shape":
        prim = prim[:, None]
    elif case == "bary dtype":
        bary = bary.double()
    elif case == "bary shape":
        bary = bary[:-1]
    elif case == "mixed devices":
        prim = prim.to("meta")
    return (tri_pack, vert_pack, tri_geom, mat_pack), prim, bary


@pytest.mark.parametrize("case, error", [
    ("table dtype", TypeError), ("table width", ValueError),
    ("non-contiguous table", ValueError), ("row counts", ValueError),
    ("empty table", ValueError), ("prim dtype", TypeError),
    ("prim shape", TypeError), ("bary dtype", TypeError),
    ("bary shape", ValueError), ("mixed devices", ValueError)])
def test_gather_surface_rejects_bad_arguments(case, error):
    tables = _torch(*_random_tables(8))
    prim, bary = _torch(*_hits(8, 32, 300))
    tables, prim, bary = _bad(case, tables, prim, bary)
    with pytest.raises(error):
        gather.gather_surface(*tables, prim, bary)
