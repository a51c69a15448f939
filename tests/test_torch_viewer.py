"""The port's web viewer (rtxpt_tpu_torch/app/viewer.py) on the CPU:
`ViewerApp(device="cpu")` served on a free localhost port, driven over
HTTP as the page drives it.

GET / serves the page; /api/state lists the debug views (the port's
VIEWS) and the materials (`material_info()`); /api/frame in reference
mode returns a PNG and the X-Stats header, accumulates while the camera
stands still, and moves the camera where the reference's
`ViewerApp.apply_input` puts it (run on a plain namespace, so no JAX
renderer is built); /api/material rewrites `mat_pack` and restarts
accumulation; /api/config switches to realtime and serves a 16x12
frame, then debug views; /api/screenshot writes the last frame."""
import http.client
import json
import sys
import threading
import types

import numpy as np
import pytest

from rtxpt_tpu.app.viewer import ViewerApp as JViewerApp
from rtxpt_tpu_torch.app.viewer import ViewerApp, serve
from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
from rtxpt_tpu_torch.scene import envmap as EM, procedural
from rtxpt_tpu_torch.utils import debugviews as DV
from rtxpt_tpu_torch.utils import image as IM

W, H = 16, 12


@pytest.fixture(scope="module")
def viewer():
    app = ViewerApp(procedural.build_programmer_art().finish(),
                    procedural.default_camera(W, H), W, H,
                    env=EM.bake_procedural_sky(height=32),
                    realtime_overrides=dict(mode="reference", max_bounces=2),
                    device="cpu")
    srv, th = serve(app, 0)
    yield app, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)
    assert not th.is_alive()


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None)
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def _png(data):
    assert data[:4] == b"\x89PNG"
    return IM.decode_png_rgba(data)


def _expected_camera(app, inputs):
    """The reference ViewerApp.apply_input's camera after `inputs`, from
    the port app's starting camera."""
    ns = types.SimpleNamespace(eye=app.eye.copy(), yaw=app.yaw,
                               pitch=app.pitch, moved=False)
    for keys, dx, dy, fast in inputs:
        JViewerApp.apply_input(ns, set(keys), dx, dy, fast)
    return ns


def test_page_and_state(viewer):
    app, port = viewer
    status, page, hdrs = _req(port, "GET", "/")
    assert status == 200 and b"canvas" in page
    assert b"<title>rtxpt_tpu_torch viewer</title>" in page
    assert hdrs["Content-Type"] == "text/html"
    status, state, _ = _req(port, "GET", "/api/state")
    state = json.loads(state)
    assert status == 200
    assert (state["width"], state["height"]) == (W, H)
    assert state["debug_views"] == DV.VIEWS
    assert state["materials"] == app._renderer.material_info()
    assert _req(port, "GET", "/nothing")[0] == 404


def test_reference_frames_material_and_realtime(viewer, tmp_path):
    app, port = viewer
    inputs = [(["w", "d"], 3.0, -2.0, False), ([], 0.0, 0.0, False),
              (["e"], 0.0, 0.0, True)]
    want = _expected_camera(app, inputs)
    for keys, dx, dy, fast in inputs:
        status, png, hdrs = _req(port, "POST", "/api/frame",
                                 dict(keys=keys, dx=dx, dy=dy, fast=fast))
        assert status == 200
        assert _png(png).shape == (H, W, 4)
        assert "ms/sample" in hdrs["X-Stats"]
    np.testing.assert_array_equal(app.eye, want.eye)
    assert (app.yaw, app.pitch) == (want.yaw, want.pitch)
    # the last move restarted accumulation; two still frames add to it
    _req(port, "POST", "/api/frame", {"keys": []})
    _req(port, "POST", "/api/frame", {"keys": []})
    assert app._renderer.sample_index == 3

    # material editor: no rebuild, mat_pack rewritten, accumulation
    # restarts
    rend = app._renderer
    status, _, _ = _req(port, "POST", "/api/material",
                        {"index": 0, "base_color": [1.0, 0.0, 0.0],
                         "roughness": 0.9})
    assert status == 200 and app._renderer is rend
    mp = rend.scene.mat_pack.numpy()
    np.testing.assert_array_equal(mp[0, 0:3], [1.0, 0.0, 0.0])
    assert mp[0, 4] == np.float32(0.9)
    _req(port, "POST", "/api/frame", {"keys": []})
    assert rend.sample_index == 1

    # screenshot of the last frame
    app.screenshot_path = str(tmp_path / "shot.png")
    status, out, _ = _req(port, "POST", "/api/screenshot")
    assert json.loads(out)["saved"] == app.screenshot_path
    assert IM.load_png(app.screenshot_path).shape[:2] == (H, W)

    # realtime mode: the renderer is rebuilt, frames come from it
    _req(port, "POST", "/api/config", {"mode": "realtime",
                                       "exposure": 1.0})
    assert isinstance(app._renderer, RealtimeRenderer)
    status, png, hdrs = _req(port, "POST", "/api/frame", {"keys": ["s"]})
    assert status == 200 and _png(png).shape == (H, W, 4)
    assert "ms/frame" in hdrs["X-Stats"]
    assert app._renderer.last_stable_planes is not None
    # debug views through the same endpoint: a surface view and a view
    # of the realtime frame's stable planes
    for view in ("FirstHitShadingNormal", "StablePlaneCount"):
        _req(port, "POST", "/api/config", {"debug_view": view})
        status, png, hdrs = _req(port, "POST", "/api/frame", {"keys": []})
        assert status == 200 and _png(png).shape == (H, W, 4)
        assert hdrs["X-Stats"] == f"debug%3A{view}"
    _req(port, "POST", "/api/config", {"debug_view": "none",
                                       "mode": "reference"})


def test_concurrent_frames_are_serialised(viewer):
    """Frames requested from many threads at once each render under the
    app's lock: every still frame adds one sample, none is lost."""
    app, port = viewer
    _req(port, "POST", "/api/frame", {"keys": []})
    start = app._renderer.sample_index
    codes, threads = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(8):
            th = threading.Thread(target=lambda: codes.extend(
                _req(port, "POST", "/api/frame", {"keys": []})[0]
                for _ in range(2)))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert codes == [200] * 16
    assert app._renderer.sample_index == start + 16
