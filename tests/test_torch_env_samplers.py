"""The distant samplers of NEE (scene/envmap.py): the uniform sampler, the
hierarchical MIP descent and the presampled list against the reference's
on the same tables and seeded uniforms; renders with the uniform and the
presampled distant sampler against the reference's
(tests/reference_configs.py); the Radiance .hdr reader against the
reference's on files the test writes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_configs import assert_matches, render_pair
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu_torch.scene import envmap as TEM

CONFIGS = {"uniform": (1, dict(nee_distant_type=0)),
           "presampled": (1, dict(nee_distant_type=2))}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_distant_sampler_render_matches_reference(monkeypatch, name):
    spp, cfg = CONFIGS[name]
    assert_matches(*render_pair(monkeypatch, spp, **cfg))


def _radiance():
    return np.asarray(JEM.bake_procedural_sky(height=32))


def _envs():
    radiance = _radiance()
    return (JEM.make_envmap(radiance, intensity=1.5),
            TEM.make_envmap(radiance, intensity=1.5, device="cpu"))


def _u(n, k, seed=11):
    u = np.random.RandomState(seed).rand(n, k).astype(np.float32)
    u[:4] = [[0.0] * k, [0.5] * k, [0.999999] * k, [0.25] * k]
    return u


def _close(ref, got, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def test_pyramid_matches_reference():
    je, _ = _envs()
    pyr = TEM.build_mip_pyramid(_radiance(), device="cpu")
    np.testing.assert_array_equal(pyr.top.numpy(),
                                  np.asarray(je.mips[0]).reshape(-1))
    assert len(pyr.quads) == len(je.quads)
    for q_t, q_j in zip(pyr.quads, je.quads):
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))


@pytest.mark.parametrize("name", ["sample_uniform", "sample_mip_descent",
                                  "sample_importance"])
def test_samplers_match_reference(name):
    je, te = _envs()
    u = _u(2048, 2)
    d_j, pdf_j, le_j = getattr(JEM, name)(je, jnp.asarray(u))
    args = (te, torch.as_tensor(u))
    if name == "sample_mip_descent":
        args = (te, TEM.build_mip_pyramid(_radiance(), device="cpu"),
                args[1])
    d_t, pdf_t, le_t = getattr(TEM, name)(*args)
    _close(d_j, d_t)
    _close(pdf_j, pdf_t)
    _close(le_j, le_t)
    # the pdfs of the drawn directions (but the edge uniforms', whose
    # directions fall on texel borders, where atan2 and acos may round
    # either way)
    d = d_t[4:]
    _close(JEM.pdf_uniform(je, jnp.asarray(d.numpy())),
           TEM.pdf_uniform(te, d))
    _close(JEM.pdf_mip_descent(je, jnp.asarray(d.numpy())),
           TEM.pdf_mip_descent(te, d))


def test_mip_descent_draws_the_alias_pmf():
    """The descent and the alias rows draw the same texel distribution:
    the pdf of each draw is that of its texel (pdf_mip_descent)."""
    _, te = _envs()
    u = torch.as_tensor(_u(4096, 2, seed=3))
    pyr = TEM.build_mip_pyramid(_radiance(), device="cpu")
    for d, pdf, _ in (TEM.sample_mip_descent(te, pyr, u),
                      TEM.sample_importance(te, u)):
        ok = pdf > 0
        np.testing.assert_allclose(TEM.pdf_mip_descent(te, d)[ok].numpy(),
                                   pdf[ok].numpy(), rtol=1e-6)


@pytest.mark.parametrize("sample_index", [0, 5])
def test_presampled_matches_reference(sample_index):
    je, te = _envs()
    pj = JEM.presample(je, sample_index, count=512)
    pt = TEM.presample(te, sample_index, count=512)
    _close(pj.dirs, pt.dirs)
    _close(pj.pdf, pt.pdf)
    _close(pj.le, pt.le)
    u1 = _u(1000, 1)[:, 0]
    for a, b in zip(JEM.sample_presampled(je, pj, jnp.asarray(u1)),
                    TEM.sample_presampled(te, pt, torch.as_tensor(u1))):
        _close(a, b)


def _write_hdr(path, rgbe, rle: bool):
    """A Radiance file of (H, W, 4) uint8 RGBE pixels: new-style RLE
    scanlines (literal and run packets) or flat ones."""
    h, w = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        if not rle:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row, x = rgbe[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run > 2:
                    out += bytes([128 + run, row[x]])
                    x += run
                else:
                    n = min(w - x, 128)
                    out += bytes([n]) + row[x:x + n].tobytes()
                    x += n
    path.write_bytes(bytes(out))


@pytest.mark.parametrize("rle", [True, False])
def test_load_equirect_matches_reference(tmp_path, rle):
    r = np.random.RandomState(5)
    h, w = 24, 48
    rgbe = r.randint(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[:, :, 3] = r.randint(120, 140, (h, w))
    rgbe[0, :8] = [10, 20, 30, 128]        # a run in every channel
    rgbe[1, 3] = [1, 2, 3, 0]              # a zero exponent
    rgbe[2, 0] = [9, 9, 9, 130]            # a flat row's first pixel
    path = tmp_path / "sky.hdr"
    _write_hdr(path, rgbe, rle)
    raw = TEM._load_radiance_hdr(str(path))
    np.testing.assert_array_equal(raw, JEM._load_radiance_hdr(str(path)))
    assert raw.shape == (h, w, 3) and raw[1, 3].max() == 0.0
    for th in (None, 8):
        got = TEM.load_equirect(str(path), th)
        np.testing.assert_array_equal(got,
                                      JEM.load_equirect(str(path), th))
    assert TEM.load_equirect(str(path)).shape == (16, 32, 3)


@pytest.mark.parametrize("ext", [".exr", ".png", ".jpg"])
def test_load_equirect_refuses_other_formats(tmp_path, ext):
    """.exr and other images raise NotImplementedError; .png is read (its
    PNG reader refuses a file that is not one)."""
    path = tmp_path / f"sky{ext}"
    path.write_bytes(b"\0" * 16)
    if ext == ".png":
        with pytest.raises(ValueError, match="not a PNG"):
            TEM.load_equirect(str(path))
    else:
        with pytest.raises(NotImplementedError, match="hdr"):
            TEM.load_equirect(str(path))


def _rle_file(h, w, body: bytes) -> bytes:
    return (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {h} +X {w}\n".encode() + bytes([2, 2, w >> 8, w & 255])
            + body)


@pytest.mark.parametrize("body", [
    _rle_file(1, 8, bytes([0])),                     # literal of length 0
    _rle_file(1, 8, bytes([128, 7])),                # run of length 0
    _rle_file(1, 8, bytes([128 + 9, 7])),            # run past the row
    _rle_file(1, 8, bytes([6]) + bytes(6) + bytes([3])),  # literal past it
    _rle_file(1, 8, bytes([128 + 8, 7, 128 + 8])),   # cut inside a run
    _rle_file(1, 8, bytes([8, 1, 2])),               # cut inside a literal
    _rle_file(1, 8, b""),                            # cut after the head
    _rle_file(2, 8, bytes([128 + 8, 7]) * 4),        # second row missing
], ids=["literal0", "run0", "run_past", "literal_past", "cut_run",
        "cut_literal", "cut_head", "cut_row"])
def test_load_radiance_hdr_refuses_malformed(tmp_path, body):
    """A malformed or cut-off file raises ValueError instead of hanging
    (an RLE packet of length 0) or reading past its buffers."""
    path = tmp_path / "bad.hdr"
    path.write_bytes(body)
    with pytest.raises(ValueError, match="hdr"):
        TEM._load_radiance_hdr(str(path))
    with pytest.raises(ValueError, match="hdr"):
        TEM.load_equirect(str(path))


def test_load_radiance_hdr_refuses_cut_flat_file(tmp_path):
    rgbe = np.full((2, 8, 4), 128, np.uint8)
    path = tmp_path / "flat.hdr"
    _write_hdr(path, rgbe, rle=False)
    path.write_bytes(path.read_bytes()[:-5])
    with pytest.raises(ValueError, match="truncated"):
        TEM._load_radiance_hdr(str(path))
