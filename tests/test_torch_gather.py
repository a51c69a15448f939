"""Row gathers (rtxpt_tpu_torch/ops/gather.py) against the reference.

K2 has no interpret mode in the reference; its CPU oracle is the plain
`table[idx]` the reference runs on CPU (exact). K3 runs against the
reference's Pallas kernel in interpret mode, whose bf16 residual planes
carry the full float32 mantissa: rtol 2e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.ops import gather_pallas as GPL
from rtxpt_tpu_torch.ops import cuda_lib, gather


def _tables(seed):
    r = np.random.RandomState(seed)
    f = r.normal(size=(700, 12)).astype(np.float32) * 10.0
    i = r.randint(-(1 << 22), 1 << 22, size=(700, 4)).astype(np.int32)
    return f, i


@pytest.mark.parametrize("kind", ["f32", "i32"])
@pytest.mark.parametrize("shape", [(1000,), (40, 25)])
def test_gather_rows_matches_reference(kind, shape):
    f, i = _tables(0)
    table = f if kind == "f32" else i
    idx = np.random.RandomState(1).randint(0, 700, size=shape)
    ref = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = gather.gather_rows(torch.as_tensor(table), torch.as_tensor(idx))
    assert got.shape == shape + (table.shape[1],)
    assert got.dtype == torch.as_tensor(table).dtype
    assert np.array_equal(got.numpy(), ref)


def test_gather_rows_clamps_indices():
    f, _ = _tables(2)
    idx = np.array([-5, 0, 699, 700, 10_000])
    got = gather.gather_rows(torch.as_tensor(f), torch.as_tensor(idx))
    assert np.array_equal(got.numpy(), f[np.clip(idx, 0, 699)])


def test_gather_rows_interp_matches_reference_kernel():
    f, _ = _tables(3)
    r = np.random.RandomState(4)
    idx3 = r.randint(0, 700, size=(1500, 3)).astype(np.int32)
    w3 = r.dirichlet([1.0, 1.0, 1.0], size=1500).astype(np.float32)
    ref = np.asarray(GPL.gather_rows_interp(GPL.pack_f32(f),
                                            jnp.asarray(idx3),
                                            jnp.asarray(w3), interpret=True))
    got = gather.gather_rows_interp(torch.as_tensor(f), torch.as_tensor(idx3),
                                    torch.as_tensor(w3))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=2e-6)
    # the plain version blends in the kernel's order, exactly
    exact = (f[idx3[:, 0]] * w3[:, 0:1] + f[idx3[:, 1]] * w3[:, 1:2]) \
        + f[idx3[:, 2]] * w3[:, 2:3]
    assert np.array_equal(got.numpy(), exact)


def test_cpu_tensors_take_plain_version_without_launch():
    f, _ = _tables(5)
    cuda_lib.reset_launch_counts()
    gather.gather_rows(torch.as_tensor(f), torch.arange(10))
    gather.gather_rows_interp(torch.as_tensor(f),
                              torch.zeros((4, 3), dtype=torch.int32),
                              torch.full((4, 3), 1.0 / 3.0))
    assert cuda_lib.launch_counts()["gather_rows"] == 0
    assert cuda_lib.launch_counts()["gather_rows_interp"] == 0


def test_other_devices_raise():
    table = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError):
        gather.gather_rows(table, torch.zeros(3, dtype=torch.int32,
                                              device="meta"))
    with pytest.raises(ValueError):
        gather.gather_rows(torch.zeros((4, 2)),
                           torch.zeros(3, dtype=torch.int32, device="meta"))
