"""The plain reference (`benchmark/refpt`) against witnesses that share
none of its code: the JAX package `rtxpt_tpu`, from which the port was
written, and the golden images that package rendered (`assets/`). The
reference renders programmer-art whole, at every pixel, through the same
entry that replays a cell's pixels (`benchlib.check.reference_pixels`),
with the cell's configuration and camera. CPU only.

- against the JAX package's Renderer on the HDR image, at the tolerance
  the port's own whole-render test holds (rtol 2e-4, atol 5e-5), with the
  cell's settings (30 bounces, 6 diffuse, NEE 2+2, Russian roulette) and
  two render calls, so that the second call's sample indices and the
  running mean are covered;
- against the committed golden images, tone-mapped as the goldens were,
  at the fast gate the JAX package holds its own renders to (PSNR > 45
  dB, SMAPE < 0.01).
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import _paths  # noqa: F401
import run
from benchlib import check, scenes

CELL = "art_ref_800x600"
ASSETS = Path(__file__).resolve().parents[2] / "assets"


def _config():
    return run.load_cell(run.read_manifest(), CELL)[2]


def refpt_image(w: int, h: int, spp: int, calls: int = 1) -> np.ndarray:
    """(h, w, 3) HDR: the reference's accumulation of `calls` render calls
    of `spp` samples at every pixel."""
    torch.set_num_threads(4)
    cfg = _config()
    img = check.reference_pixels(
        host=scenes.host_scene(cfg), env_radiance=scenes.env_radiance(cfg),
        camera=scenes.camera(cfg), settings=cfg["settings"], width=w,
        height=h, spp=spp, calls=calls, pixels=np.arange(w * h),
        device=torch.device("cpu"))
    return img.numpy().reshape(h, w, 3)


def test_refpt_agrees_with_the_jax_package(monkeypatch):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    pytest.importorskip("jax")
    # the JAX package's dense trace and shade megakernel in interpret
    # mode: the algorithm the port (and so the reference) carries
    monkeypatch.setenv("RTXPT_SHADE_KERNEL", "1")
    monkeypatch.setenv("RTXPT_SHADE_KERNEL_INTERPRET", "1")
    monkeypatch.setenv("RTXPT_DENSE_INTERPRET", "1")
    from rtxpt_tpu.models.renderer import Renderer, reference_config
    from rtxpt_tpu.scene import envmap, procedural

    cfg = _config()
    w, h, spp = 16, 12, 2
    jr = Renderer(procedural.build_programmer_art().finish(),
                  procedural.default_camera(w, h),
                  reference_config(**cfg["settings"]),
                  env_radiance=envmap.bake_procedural_sky(
                      height=int(cfg["env"]["sky_rows"])))
    jr.render(w, h, spp)
    ref = np.asarray(jr.render(w, h, spp))
    got = refpt_image(w, h, spp, calls=2)
    assert np.isfinite(got).all() and got.mean() > 0.0
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=5e-5)


# the golden images' tone mapping: histogram auto-exposure, the ACES fit
# (Narkowicz) and the sRGB curve (ToneMappingPasses.cpp:364-460)
_BINS, _LOG_MIN, _LOG_MAX = 128, -10.0, 8.0


def tonemap(rgb: torch.Tensor) -> torch.Tensor:
    rgb = torch.clamp(rgb, min=0.0)
    lum = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    t = (torch.log2(torch.clamp(lum, min=1e-10)) - _LOG_MIN) \
        / (_LOG_MAX - _LOG_MIN)
    bins = torch.clamp((t * _BINS).to(torch.int64), 0, _BINS - 1)
    hist = torch.bincount(bins.reshape(-1), minlength=_BINS).to(
        torch.float32)
    cdf = torch.cumsum(hist, 0)
    lo, hi = 0.6 * cdf[-1], 0.95 * cdf[-1]
    inside = torch.minimum(torch.maximum(cdf, lo), hi) - torch.minimum(
        torch.maximum(cdf - hist, lo), hi)
    centers = _LOG_MIN + (torch.arange(_BINS, dtype=torch.float32) + 0.5) \
        / _BINS * (_LOG_MAX - _LOG_MIN)
    avg = torch.clamp(torch.sum(inside * centers)
                      / torch.clamp(torch.sum(inside), min=1e-5), -12.0, 12.0)
    x = rgb * (0.18 / torch.exp2(avg))
    y = torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14),
                    0.0, 1.0)
    return torch.where(y <= 0.0031308, y * 12.92, 1.055 * torch.pow(
        torch.clamp(y, min=1e-7), 1.0 / 2.4) - 0.055)


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    """PSNR and SMAPE of two images in [0, 1] (tools/compare_images.py)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    mse = float(np.mean((a - b) ** 2))
    peak = max(a.max(), b.max(), 1e-9)
    return dict(psnr=float(10.0 * np.log10(peak * peak / max(mse, 1e-20))),
                smape=float(np.mean(np.abs(a - b)
                                    / (np.abs(a) + np.abs(b) + 1e-3))))


@pytest.mark.parametrize("w,h,spp", [(64, 48, 2), (96, 72, 4)])
def test_refpt_matches_the_golden_images(w, h, spp):
    Image = pytest.importorskip("PIL.Image")
    golden = np.asarray(Image.open(
        ASSETS / f"golden_programmer_art_{w}x{h}_{spp}spp.png"
    ).convert("RGB")).astype(np.float32) / 255.0
    img = tonemap(torch.as_tensor(refpt_image(w, h, spp))).numpy()
    m = compare(img, golden)
    print(f"refpt {w}x{h} {spp}spp vs golden: PSNR {m['psnr']:.2f} dB, "
          f"SMAPE {m['smape']:.5f}")
    assert m["psnr"] > 45.0, m
    assert m["smape"] < 0.01, m
