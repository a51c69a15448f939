"""The animated scenes' device code on the card against the CPU: the BVH8
refit and the dense planes' refresh bit for bit, and the instanced TLAS's
rounds (one K5 launch each) against its plain version on the CPU.

Marked `cuda`; each test skips without a GPU. On a machine with one (and
without JAX, which the tests' conftest needs), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_animated.py -q

This file imports nothing of JAX or of the reference package."""
import numpy as np
import pytest
import torch

from rtxpt_tpu_torch.ops import cuda_lib, mt_dense
from rtxpt_tpu_torch.scene import procedural

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def test_refits_on_card_bit_equal_to_cpu(dev):
    """refit_bvh8 and refresh_dense of the same posed positions: the
    card's tables equal the CPU's bit for bit."""
    from rtxpt_tpu_torch.ops import bvh
    from rtxpt_tpu_torch.scene import animation as AN
    r = np.random.RandomState(3)
    c = r.uniform(-3, 3, (4000, 3))
    pos = np.concatenate([c + r.uniform(-0.3, 0.3, c.shape)
                          for _ in range(3)]).astype(np.float32)
    idx = np.ascontiguousarray(
        np.arange(12000, dtype=np.int32).reshape(3, 4000).T)
    posed = (pos + r.normal(0, 0.05, pos.shape)).astype(np.float32)
    b2 = bvh.build_bvh(pos, idx)
    tables = []
    for device in (dev, "cpu"):
        p, i = (torch.as_tensor(a, device=device) for a in (posed, idx))
        b8 = AN.refit_bvh8(bvh.collapse_bvh8(b2, pos, idx, device=device),
                           p, i)
        d = mt_dense.refresh_dense(mt_dense.build_dense(
            pos, idx[:2000], device=device), p, i[:2000])
        tables.append((b8.table.cpu(), d.aabb.cpu(), d.tri12.cpu()))
    for g, c in zip(*tables):
        assert torch.equal(g, c)


def test_instanced_rounds_on_card_match_cpu(dev):
    """The instanced TLAS on the card (one K5 launch a round) against its
    plain version on the CPU: the same prims, t bits and occlusion."""
    from rtxpt_tpu_torch.ops import instanced
    inst = procedural.build_city(blocks=2).finish()["instancing"]
    r = np.random.RandomState(5)
    o = (r.uniform(-1, 1, (20000, 3)) * [12, 4, 12] + [0, 5, 0]).astype(
        np.float32)
    d = r.normal(size=(20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out = []
    for device in (dev, "cpu"):
        tl = instanced.build_instanced(inst, device)
        rays = (torch.as_tensor(o, device=device),
                torch.as_tensor(d, device=device))
        cuda_lib.reset_launch_counts()
        stats = {}
        hit = instanced.trace_closest(tl, *rays, stats=stats)
        occ = instanced.trace_anyhit(tl, *rays, t_max=20.0, stats=stats)
        launches = cuda_lib.launch_counts()["bvh8_trace"]
        assert launches == (stats["rounds"] if device == dev else 0)
        out.append((hit.prim.cpu(), hit.t.cpu(), occ.cpu()))
    (gp, gt, go), (cp, ct, co) = out
    assert (gp >= 0).sum() > 1000
    assert torch.equal(gp, cp) and torch.equal(go, co)
    assert torch.equal(gt.view(torch.int32), ct.view(torch.int32))
