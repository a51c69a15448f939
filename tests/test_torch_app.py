"""The port's entry points on the CPU: the headless CLI, the PNG writer
and reader, and chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import numpy as np

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
