"""Fused shade+NEE pass (rtxpt_tpu_torch/pt/shade_kernel.py, plain version
of K4) against the reference megakernel in interpret mode, on the same
seeded-numpy planes, with the tolerance of tests/test_shade_kernel.py
(rtol 2e-4 / atol 2e-5: the two differ only in float re-association and
the transcendental implementations of XLA and PyTorch). The scattered
direction is a unit vector rotated out of the local frame: its small
components come out of cancellation, where one-ulp sin/cos differences
in the sampled local direction reach 3e-5, so that row is held to an
absolute 1e-4."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.pt import shade_kernel as JSK
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.pt import shade_kernel as TSK

N = 700
CU = os.path.join(os.path.dirname(__file__), "..", "rtxpt_tpu_torch", "csrc",
                  "shade_kernel.cu")


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _planes(nd, nl, seed, min_rough=0.2):
    """Plausible per-lane inputs: orthonormal shading frames, BSDF data
    over every lobe (diffuse, rough/delta metal, rough/delta glass, thin,
    diffuse transmission), all local light kinds. Roughness is 0 (delta)
    or at least `min_rough`."""
    r = np.random.RandomState(seed)
    n = _unit(r, N)
    t = np.cross(n, _unit(r, N))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(n, t)
    v = _unit(r, N)
    v = np.where((np.sum(v * n, -1) < 0)[:, None] & (r.rand(N) < 0.9)[:, None],
                 -v, v)
    face_n = n + 0.1 * r.normal(size=(N, 3))
    face_n /= np.linalg.norm(face_n, axis=-1, keepdims=True)
    pick = lambda *opts: np.asarray(opts)[r.randint(0, len(opts), N)]
    vals = dict(
        pos=r.uniform(-3, 3, (N, 3)), n=n, t=t, b=b, face_n=face_n,
        vertex_n=n, v=v,
        emission=np.where(r.rand(N, 1) < 0.1, r.uniform(0, 20, (N, 3)), 0),
        front_facing=r.rand(N) < 0.9, thin=r.rand(N) < 0.1,
        shadow_fade=np.where(r.rand(N) < 0.2, r.uniform(0, 0.2, N), 0),
        bd_diffuse=r.uniform(0, 1, (N, 3)),
        bd_specular=r.uniform(0, 0.5, (N, 3)),
        bd_rough=np.where(r.rand(N) < 0.3, 0.0, r.uniform(min_rough, 1, N)),
        bd_metallic=np.where(r.rand(N) < 0.5, pick(0.0, 1.0), r.rand(N)),
        bd_eta=pick(1.0, 1 / 1.5, 1.5, 1.33),
        bd_trans=r.uniform(0.5, 1, (N, 3)),
        bd_dtrans=np.where(r.rand(N) < 0.2, r.rand(N), 0),
        bd_strans=np.where(r.rand(N) < 0.3, pick(1.0, 0.5), 0),
        thp=r.uniform(0.05, 1.2, (N, 3)), radiance=r.uniform(0, 1, (N, 3)),
        origin=r.uniform(-3, 3, (N, 3)), direction=-v,
        firefly_k=r.uniform(1e-3, 1, N), emissive_mis=r.rand(N),
        env_mis=r.rand(N), cone_spread=r.uniform(0, 0.1, N),
        diffuse_bounces=r.randint(0, 6, N), vertex_index=r.randint(1, 8, N),
        shade=r.rand(N) < 0.85, nee_skip=np.zeros(N), u_rr=r.rand(N),
        u3=r.rand(N, 3))
    for i in range(nd):
        vals.update({f"ls_dir{i}": _unit(r, N),
                     f"ls_dist{i}": np.full(N, 1e15),
                     f"ls_li{i}": r.uniform(0, 5, (N, 3)),
                     f"ls_pdf{i}": np.where(r.rand(N) < 0.1, 0,
                                            r.uniform(0.01, 10, N)),
                     f"ls_valid{i}": r.rand(N) < 0.9})
    for j in range(nl):
        e1, e2 = r.uniform(-1, 1, (N, 3)), r.uniform(-1, 1, (N, 3))
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        vals.update({
            f"lrow_p0{j}": r.uniform(-3, 3, (N, 3)), f"lrow_e1{j}": e1,
            f"lrow_e2{j}": e2, f"lrow_pos{j}": r.uniform(-3, 3, (N, 3)),
            f"lrow_radius{j}": r.uniform(0.05, 0.5, N),
            f"lrow_rad{j}": r.uniform(0, 20, (N, 3)),
            f"lrow_inv_area{j}": 1.0 / np.maximum(area, 1e-3),
            f"lrow_kind{j}": pick(0, 0, 0, 1, 2, 3, 4),
            f"lrow_axis{j}": _unit(r, N),
            f"lrow_cos_cone{j}": r.uniform(0.3, 0.9, N),
            f"lrow_soft{j}": pick(0.0, 0.3),
            f"pick_pdf{j}": r.uniform(0.1, 1, N), f"u3l{j}": r.rand(N, 3)})
    L = TSK.in_layout(nd, nl)
    return TSK.pack_inputs(L, N, {k: torch.as_tensor(np.asarray(v))
                                  for k, v in vals.items()})


@pytest.mark.parametrize("nd,nl,rr,firefly", [
    (1, 1, True, 0.0), (2, 2, True, 0.0), (2, 2, False, 2.0),
    (1, 0, False, 2.0), (0, 2, True, 2.0)])
def test_plain_matches_reference_kernel(nd, nl, rr, firefly):
    """Roughness 0 or >= 0.2 (GGX alpha >= 0.04), the range of the
    programmer-art materials the reference's own test renders."""
    planes = _planes(nd, nl, seed=10 * nd + nl)
    consts4 = np.array([firefly, 1.0, 1e-5, 0.002], np.float32)
    kw = dict(nee_distant=nd, nee_local=nl, rr=rr, max_bounces=6,
              max_diffuse_bounces=4, spec_rough_threshold=0.25,
              local_pdf_k=1.0)
    ref = np.asarray(JSK.shade_nee_pallas(
        jnp.asarray(planes.numpy()), jnp.asarray(consts4), fill=False,
        interpret=True, **kw))
    got = TSK.shade_nee(planes, torch.as_tensor(consts4), **kw).numpy()
    L = TSK.out_layout(nd, nl)
    assert got.shape == ref.shape == (L.rows, N)
    assert np.isfinite(got).all()
    d0 = L.map["direction"][0]
    rest = np.r_[0:d0, d0 + 3:L.rows]
    np.testing.assert_allclose(got[rest], ref[rest], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got[d0:d0 + 3], ref[d0:d0 + 3], rtol=0,
                               atol=1e-4)


def test_plain_matches_reference_kernel_low_roughness():
    """Roughness down to 0.05 (alpha 0.0025): the bounded-VNDF half
    vector is ill-conditioned there, and one-ulp differences between
    XLA's and PyTorch's sin/cos grow to ~0.5% in the sampled pdf and
    direction (measured 4e-3 at alpha 0.008), hence rtol 1e-2 here."""
    planes = _planes(2, 2, seed=99, min_rough=0.05)
    consts4 = np.array([0.0, 1.0, 1e-5, 0.002], np.float32)
    kw = dict(nee_distant=2, nee_local=2, rr=True, max_bounces=6,
              max_diffuse_bounces=4, spec_rough_threshold=0.25,
              local_pdf_k=1.0)
    ref = np.asarray(JSK.shade_nee_pallas(
        jnp.asarray(planes.numpy()), jnp.asarray(consts4), fill=False,
        interpret=True, **kw))
    got = TSK.shade_nee(planes, torch.as_tensor(consts4), **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-4)


@pytest.mark.parametrize("nd,nl", [(1, 1), (2, 2), (0, 0), (2, 1)])
def test_layouts_match_reference_and_kernel(nd, nl):
    """Plane layouts equal the reference's, and csrc/shade_kernel.cu
    hard-codes the same row offsets."""
    t_in, t_out = TSK.in_layout(nd, nl), TSK.out_layout(nd, nl)
    assert t_in.map == JSK.in_layout(nd, nl).map
    assert t_out.map == JSK.out_layout(nd, nl, False).map
    src = open(CU).read()
    c = {k: int(v) for k, v in re.findall(
        r"constexpr int ([A-Z0-9_]+) = (\d+);", src)}
    for name, (row, _) in t_in.map.items():
        m = re.fullmatch(r"(ls|lrow)_(\w+?)(\d)|u3l(\d)|pick_pdf(\d)", name)
        if m is None:
            assert c["IN_" + name.upper()] == row, name
            continue
        if name.startswith("ls_"):
            i = int(m.group(3))
            off = c["IN_FIXED"] + c["DIST_ROWS"] * i + \
                c["DIST_" + m.group(2).upper()]
        else:
            j = int(m.group(3) or m.group(4) or m.group(5))
            field = "U3L" if name.startswith("u3l") else (
                "PICK_PDF" if name.startswith("pick_pdf")
                else m.group(2).upper())
            off = c["IN_FIXED"] + c["DIST_ROWS"] * nd + \
                c["LOCAL_ROWS"] * j + c["LOC_" + field]
        assert off == row, name
    assert c["IN_FIXED"] + c["DIST_ROWS"] * nd + c["LOCAL_ROWS"] * nl \
        == t_in.rows
    for name, (row, _) in t_out.map.items():
        m = re.fullmatch(r"nee_(dir|dist|need|contrib)(\d)", name)
        if m is None:
            assert c["OUT_" + name.upper()] == row, name
        else:
            assert c["OUT_FIXED"] + c["NEE_OUT_ROWS"] * int(m.group(2)) + \
                c["NEE_" + m.group(1).upper()] == row, name
    assert c["OUT_FIXED"] + c["NEE_OUT_ROWS"] * (nd + nl) == t_out.rows


def test_cpu_planes_take_plain_version_without_launch():
    planes = _planes(1, 1, seed=3)
    cuda_lib.reset_launch_counts()
    TSK.shade_nee(planes, torch.tensor([0.0, 1.0, 1e-5, 0.002]),
                  nee_distant=1, nee_local=1, rr=True, max_bounces=6,
                  max_diffuse_bounces=4, spec_rough_threshold=0.25,
                  local_pdf_k=1.0)
    assert cuda_lib.launch_counts()["shade_nee"] == 0
