"""Seeded input planes of the fused shade + NEE pass (K4), shared by the
CPU parity tests (test_torch_shade_kernel.py) and the card's tests
(test_torch_cuda.py). Imports nothing of JAX or of the reference package."""
import numpy as np
import torch

from rtxpt_tpu_torch.pt import shade_kernel as TSK

N = 700


def unit(r, n):
    v = r.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def planes(nd, nl, seed, min_rough=0.2, lanes=N):
    """Plausible per-lane inputs: orthonormal shading frames, BSDF data
    over every lobe (diffuse, rough/delta metal, rough/delta glass, thin,
    diffuse transmission), all local light kinds. Roughness is 0 (delta)
    or at least `min_rough`. `lanes` lanes (N by default)."""
    r = np.random.RandomState(seed)
    n = unit(r, lanes)
    t = np.cross(n, unit(r, lanes))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(n, t)
    v = unit(r, lanes)
    v = np.where((np.sum(v * n, -1) < 0)[:, None]
                 & (r.rand(lanes) < 0.9)[:, None], -v, v)
    face_n = n + 0.1 * r.normal(size=(lanes, 3))
    face_n /= np.linalg.norm(face_n, axis=-1, keepdims=True)
    pick = lambda *opts: np.asarray(opts)[r.randint(0, len(opts), lanes)]
    vals = dict(
        pos=r.uniform(-3, 3, (lanes, 3)), n=n, t=t, b=b, face_n=face_n,
        vertex_n=n, v=v,
        emission=np.where(r.rand(lanes, 1) < 0.1,
                          r.uniform(0, 20, (lanes, 3)), 0),
        front_facing=r.rand(lanes) < 0.9, thin=r.rand(lanes) < 0.1,
        shadow_fade=np.where(r.rand(lanes) < 0.2,
                             r.uniform(0, 0.2, lanes), 0),
        bd_diffuse=r.uniform(0, 1, (lanes, 3)),
        bd_specular=r.uniform(0, 0.5, (lanes, 3)),
        bd_rough=np.where(r.rand(lanes) < 0.3, 0.0,
                          r.uniform(min_rough, 1, lanes)),
        bd_metallic=np.where(r.rand(lanes) < 0.5, pick(0.0, 1.0),
                             r.rand(lanes)),
        bd_eta=pick(1.0, 1 / 1.5, 1.5, 1.33),
        bd_trans=r.uniform(0.5, 1, (lanes, 3)),
        bd_dtrans=np.where(r.rand(lanes) < 0.2, r.rand(lanes), 0),
        bd_strans=np.where(r.rand(lanes) < 0.3, pick(1.0, 0.5), 0),
        thp=r.uniform(0.05, 1.2, (lanes, 3)),
        radiance=r.uniform(0, 1, (lanes, 3)),
        origin=r.uniform(-3, 3, (lanes, 3)), direction=-v,
        firefly_k=r.uniform(1e-3, 1, lanes), emissive_mis=r.rand(lanes),
        env_mis=r.rand(lanes), cone_spread=r.uniform(0, 0.1, lanes),
        diffuse_bounces=r.randint(0, 6, lanes),
        vertex_index=r.randint(1, 8, lanes), shade=r.rand(lanes) < 0.85,
        nee_skip=np.zeros(lanes), u_rr=r.rand(lanes), u3=r.rand(lanes, 3))
    for i in range(nd):
        vals.update({f"ls_dir{i}": unit(r, lanes),
                     f"ls_dist{i}": np.full(lanes, 1e15),
                     f"ls_li{i}": r.uniform(0, 5, (lanes, 3)),
                     f"ls_pdf{i}": np.where(r.rand(lanes) < 0.1, 0,
                                            r.uniform(0.01, 10, lanes)),
                     f"ls_valid{i}": r.rand(lanes) < 0.9})
    for j in range(nl):
        e1 = r.uniform(-1, 1, (lanes, 3))
        e2 = r.uniform(-1, 1, (lanes, 3))
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        vals.update({
            f"lrow_p0{j}": r.uniform(-3, 3, (lanes, 3)), f"lrow_e1{j}": e1,
            f"lrow_e2{j}": e2, f"lrow_pos{j}": r.uniform(-3, 3, (lanes, 3)),
            f"lrow_radius{j}": r.uniform(0.05, 0.5, lanes),
            f"lrow_rad{j}": r.uniform(0, 20, (lanes, 3)),
            f"lrow_inv_area{j}": 1.0 / np.maximum(area, 1e-3),
            f"lrow_kind{j}": pick(0, 0, 0, 1, 2, 3, 4),
            f"lrow_axis{j}": unit(r, lanes),
            f"lrow_cos_cone{j}": r.uniform(0.3, 0.9, lanes),
            f"lrow_soft{j}": pick(0.0, 0.3),
            f"pick_pdf{j}": r.uniform(0.1, 1, lanes),
            f"u3l{j}": r.rand(lanes, 3)})
    L = TSK.in_layout(nd, nl)
    return TSK.pack_inputs(L, lanes, {k: torch.as_tensor(np.asarray(v))
                                      for k, v in vals.items()})
