"""The port's entry points on the CPU: the headless CLI, the PNG writer
and reader, and chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from rtxpt_tpu_torch.app import cli
from rtxpt_tpu_torch.utils import image as IM

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_cli_renders_on_cpu(tmp_path):
    out, npy = str(tmp_path / "o.png"), str(tmp_path / "o.npy")
    ckpt = str(tmp_path / "c.npz")
    args = ["--width", "24", "--height", "16", "--spp", "2", "--device",
            "cpu", "--max-bounces", "3", "--output", out, "--dump-npy", npy,
            "--checkpoint", ckpt, "--quiet"]
    assert cli.main(args) == 0
    hdr = np.load(npy)
    img = IM.load_png(out)
    assert hdr.shape == img.shape == (16, 24, 3)
    assert np.isfinite(hdr).all() and hdr.mean() > 0.0
    # resuming the checkpoint accumulates two more samples
    assert cli.main(args) == 0
    assert int(np.load(ckpt)["sample_index"]) == 4


def test_cli_renders_city_on_cpu(tmp_path):
    """--scene city: the default 404,186-triangle city through the
    two-level BVH8 tier (about 8 s on one CPU core, most of it the build)."""
    npy = str(tmp_path / "c.npy")
    args = ["--scene", "city", "--width", "8", "--height", "6", "--spp",
            "1", "--device", "cpu", "--max-bounces", "2", "--output",
            str(tmp_path / "c.png"), "--dump-npy", npy, "--quiet"]
    assert cli.main(args) == 0
    hdr = np.load(npy)
    assert hdr.shape == (6, 8, 3)
    assert np.isfinite(hdr).all() and hdr.mean() > 0.0


@pytest.mark.parametrize("preset", [
    [], ["--preset", "ref-vs-realtime"], ["--no-stable-planes"],
    ["--no-stable-planes", "--preset", "ref-vs-realtime"]],
    ids=["default", "ref-vs-realtime", "psr-lite", "psr-lite-ref-vs-realtime"])
def test_cli_realtime_on_cpu(tmp_path, preset):
    """--mode realtime: 2 frames of the realtime pipeline (stable planes,
    or PSR-lite with --no-stable-planes), the last saved."""
    npy, png = str(tmp_path / "r.npy"), str(tmp_path / "r.png")
    args = ["--mode", "realtime", "--width", "16", "--height", "12",
            "--spp", "2", "--device", "cpu", "--max-bounces", "2",
            "--output", png, "--dump-npy", npy, "--quiet"] + preset
    assert cli.main(args) == 0
    hdr = np.load(npy)
    assert hdr.shape == IM.load_png(png).shape == (12, 16, 3)
    assert np.isfinite(hdr).all() and hdr.mean() > 0.0


def _hdr(path, h=8, w=16):
    """A flat-scanline Radiance file of a sky gradient."""
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.linspace(60, 200, h, dtype=np.uint8)[:, None, None]
    rgbe[..., 3] = 129
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                     + f"-Y {h} +X {w}\n".encode() + rgbe.tobytes())
    return str(path)


@pytest.mark.parametrize("extra", [["--no-nee"], ["--env", "sky.hdr"],
                                   ["--photo-denoise"]],
                         ids=["no-nee", "env", "photo-denoise"])
def test_cli_reference_options_on_cpu(tmp_path, extra):
    """--no-nee (the chain, no next-event estimation) and --env (a Radiance
    .hdr in place of the procedural sky)."""
    if "--env" in extra:
        extra = ["--env", _hdr(tmp_path / "sky.hdr")]
    npy = str(tmp_path / "o.npy")
    assert cli.main(["--width", "16", "--height", "12", "--spp", "1",
                     "--device", "cpu", "--max-bounces", "2", "--output",
                     str(tmp_path / "o.png"), "--dump-npy", npy, "--quiet"]
                    + extra) == 0
    hdr = np.load(npy)
    assert hdr.shape == (12, 16, 3)
    assert np.isfinite(hdr).all() and hdr.mean() > 0.0


@pytest.mark.parametrize("flag", [[], ["--no-nee"]], ids=["nee", "no-nee"])
def test_cli_realtime_no_nee(monkeypatch, tmp_path, flag):
    """--mode realtime --no-nee builds its config with nee_enabled False,
    and without the flag True (the reference's realtime mode ignores the
    flag; ROADMAP §3)."""
    from rtxpt_tpu_torch.models import realtime as RT
    seen = {}

    class Built(Exception):
        pass

    def init(self, host, cam, cfg=None, **kw):
        seen["cfg"] = cfg
        raise Built

    monkeypatch.setattr(RT.RealtimeRenderer, "__init__", init)
    with pytest.raises(Built):
        cli.main(["--mode", "realtime", "--width", "8", "--height", "6",
                  "--spp", "1", "--device", "cpu", "--output",
                  str(tmp_path / "o.png"), "--quiet"] + flag)
    assert seen["cfg"].nee_enabled is not bool(flag)


def test_cli_refuses_exr_env(tmp_path):
    path = tmp_path / "sky.exr"
    path.write_bytes(b"\0" * 16)
    with pytest.raises(NotImplementedError):
        cli.main(["--env", str(path), "--width", "8", "--height", "6",
                  "--spp", "1", "--device", "cpu", "--output",
                  str(tmp_path / "o.png"), "--quiet"])


def test_png_round_trip(tmp_path):
    img = np.random.RandomState(0).rand(9, 13, 3)
    path = str(tmp_path / "x.png")
    IM.save_png(path, img)
    back = np.round(IM.load_png(path) * 255.0).astype(np.uint8)
    assert np.array_equal(back, IM.to_uint8(img))


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_gpu():
    p = _run(ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run(str(tmp_path))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
