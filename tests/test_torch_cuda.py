"""CUDA kernels of the port against their plain versions, on the card.

Marked `cuda`; each test skips without a GPU. On a machine with one (and
without JAX, which the tests' conftest needs), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports nothing of JAX or of the reference package."""
import numpy as np
import pytest
import torch

from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.ops import cuda_lib, gather, mt_dense
from rtxpt_tpu_torch.pt import shade_kernel as SK
from rtxpt_tpu_torch.scene import envmap as EM
from rtxpt_tpu_torch.scene import procedural

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _renderer(device, w=32, h=24, **cfg):
    return Renderer(procedural.build_programmer_art().finish(),
                    procedural.default_camera(w, h), reference_config(**cfg),
                    env_radiance=EM.bake_procedural_sky(height=32),
                    device=device)


def test_gather_kernels_match_plain(dev):
    r = np.random.RandomState(0)
    f = torch.as_tensor(r.normal(size=(700, 12)).astype(np.float32),
                        device=dev)
    i = torch.as_tensor(r.randint(-1000, 1000, (700, 4)).astype(np.int32),
                        device=dev)
    idx = torch.as_tensor(r.randint(-3, 703, (50, 40)), device=dev)
    for table in (f, i):
        assert torch.equal(gather.gather_rows(table, idx),
                           gather.gather_rows_plain(table, idx))
    i3 = torch.as_tensor(r.randint(0, 700, (999, 3)).astype(np.int32),
                         device=dev)
    w3 = torch.as_tensor(r.rand(999, 3).astype(np.float32), device=dev)
    torch.testing.assert_close(gather.gather_rows_interp(f, i3, w3),
                               gather.gather_rows_interp_plain(f, i3, w3),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_kernel_matches_plain(dev, any_hit):
    r = np.random.RandomState(1)
    n_tris = 1000
    c = r.uniform(-4, 4, (n_tris, 3))
    pos = np.concatenate([c + r.uniform(-0.4, 0.4, (n_tris, 3))
                          for _ in range(3)]).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T
    dmt = mt_dense.build_dense(pos, idx, device=dev)
    n = 20000
    o = torch.as_tensor(r.uniform(-8, 8, (n, 3)).astype(np.float32),
                        device=dev) - dmt.center
    d = torch.nn.functional.normalize(torch.as_tensor(
        r.normal(size=(n, 3)).astype(np.float32), device=dev), dim=-1)
    tmax = torch.full((n,), 1e30, device=dev)
    act = torch.as_tensor(r.rand(n) < 0.9, device=dev)
    args = (dmt.aabb_c, dmt.tri9, o.contiguous(), d.contiguous(), tmax, act)
    t_k, s_k = mt_dense.trace_dense(*args, any_hit=any_hit)
    t_p, s_p = mt_dense.trace_dense_plain(*args, any_hit=any_hit)
    assert ((s_k >= 0) == (s_p >= 0)).float().mean() >= 0.9999
    if not any_hit:
        same = s_k == s_p
        assert same.float().mean() >= 0.9999
        torch.testing.assert_close(t_k[same], t_p[same], rtol=1e-5,
                                   atol=1e-6)


def test_shade_kernel_matches_plain(dev):
    r = _renderer(dev, max_bounces=4, nee_distant_samples=1,
                  nee_local_samples=1)
    calls = []
    orig = SK.shade_nee

    def capture(planes, consts4, **kw):
        calls.append((planes.clone(), consts4.clone(), kw))
        return orig(planes, consts4, **kw)

    SK.shade_nee = capture
    try:
        r.render(32, 24, 1)
    finally:
        SK.shade_nee = orig
    assert calls
    for planes, consts4, kw in calls[:3]:
        got = SK.shade_nee(planes, consts4, **kw)
        ref = SK.shade_nee_plain(planes, consts4, **kw)
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


def test_render_launches_every_kernel_and_matches_cpu(dev):
    cuda_lib.reset_launch_counts()
    gpu = _renderer(dev, max_bounces=3).render(32, 24, 2).cpu()
    counts = cuda_lib.launch_counts()
    assert all(v > 0 for v in counts.values()), counts
    cpu = _renderer("cpu", max_bounces=3).render(32, 24, 2)
    torch.testing.assert_close(gpu, cpu, rtol=1e-3, atol=1e-3)


def test_wrappers_reject_bad_arguments(dev):
    table = torch.zeros((8, 4), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        gather.gather_rows(table, torch.zeros(3, dtype=torch.int32,
                                              device=dev))
    with pytest.raises(ValueError):
        gather.gather_rows(torch.zeros((8, 4), device=dev),
                           torch.zeros(3, dtype=torch.int32))
