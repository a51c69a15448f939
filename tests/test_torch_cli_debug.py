"""The port CLI's debug flags (rtxpt_tpu_torch/app/cli.py) on the CPU.

`--debug-view FirstHitShadingNormal` saves the same PNG as the reference
CLI's (decoded, within 1/255); both return before the beauty render.
One call with `--debug-print-pixel`, `--debug-delta-tree` and
`--debug-lines-pixel` at 32x24, 1 spp, `--max-bounces 2`: the printed
tables equal the port library's format_slots / format_tree for the
CLI's camera, and the PNG differs from the same render without
`--debug-lines-pixel` only where the overlay drew."""
import numpy as np
import torch

from rtxpt_tpu.app import cli as jcli
from rtxpt_tpu_torch.app import cli as tcli
from rtxpt_tpu_torch.models.renderer import Renderer
from rtxpt_tpu_torch.scene import envmap as EM
from rtxpt_tpu_torch.scene import procedural
from rtxpt_tpu_torch.utils import debuglines as DL
from rtxpt_tpu_torch.utils import debugprint as DP
from rtxpt_tpu_torch.utils import deltatree as DT
from rtxpt_tpu_torch.utils import image as IM

W, H = 32, 24
PIXEL = (16, 12)
SIZE = ["--width", str(W), "--height", str(H)]


def test_debug_view_matches_reference_cli(tmp_path):
    got, want = tmp_path / "port.png", tmp_path / "ref.png"
    args = SIZE + ["--debug-view", "FirstHitShadingNormal", "--quiet"]
    assert tcli.main(args + ["--device", "cpu", "--output", str(got)]) == 0
    assert jcli.main(args + ["--output", str(want)]) == 0
    a = IM.load_png(str(got)).astype(np.int32)
    b = IM.load_png(str(want)).astype(np.int32)
    assert a.shape == b.shape == (H, W, 3)
    assert np.abs(a - b).max() <= 1
    assert a.std() > 0


def test_post_render_debug_flags(tmp_path, capsys):
    pix = f"{PIXEL[0]},{PIXEL[1]}"
    base = SIZE + ["--spp", "1", "--max-bounces", "2", "--device", "cpu",
                   "--quiet"]
    plain, lined = tmp_path / "plain.png", tmp_path / "lines.png"
    assert tcli.main(base + ["--output", str(plain)]) == 0
    capsys.readouterr()
    assert tcli.main(base + ["--output", str(lined),
                             "--debug-print-pixel", pix,
                             "--debug-delta-tree", pix,
                             "--debug-lines-pixel", pix]) == 0
    out = capsys.readouterr().out

    # the library on the CLI's scene and camera (the output size as the
    # viewport)
    r = Renderer(procedural.build_programmer_art().finish(),
                 procedural.default_camera(W, H),
                 env_radiance=EM.bake_procedural_sky(), device="cpu")
    cam = r.camera._replace(viewport=torch.tensor([W, H],
                                                  dtype=torch.float32))
    slots = DP.format_slots(DP.print_path(r.assets, cam, *PIXEL))
    tree = DT.format_tree(DT.explore_pixel(r.assets, cam, *PIXEL))
    assert out == slots + "\n" + tree + "\n"

    a, b = IM.load_png(str(plain)), IM.load_png(str(lined))
    drawn = DL.rasterize_overlay(
        torch.zeros(H, W, 3), DL.lines_for_path(r.assets, cam, *PIXEL),
        cam).amax(-1).numpy() > 0
    changed = (a != b).any(-1)
    assert changed.any()
    assert not (changed & ~drawn).any()
