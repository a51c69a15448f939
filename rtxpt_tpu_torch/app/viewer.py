"""Interactive preview window: the DeviceManager + SampleUI counterpart
(counterpart of rtxpt_tpu/app/viewer.py; donut/src/app/DeviceManager.cpp:
437 RunMessageLoop and RTXPT/SampleUI.cpp).

The renderer runs headless beside the card, so the window is a localhost
web viewer: a standard-library HTTP server streams rendered frames to a
browser canvas and takes camera and settings input back. Nothing beyond
the standard library and the port (PNGs through utils/image.py).

Surface parity (SampleUI.h controls -> panel widgets):
  * fly camera  (WASD/QE + mouse-drag look; Donut FirstPersonCamera)
  * mode        realtime (ReSTIR + denoiser + TAA) | reference
                (accumulates while the camera is still, resets on move)
  * bounce count, stable planes on/off, denoiser on/off and method
    (relax | reblur), debug view (ShaderDebug DebugViewType), exposure,
    material editor, screenshot
  * stats line  ms/frame, fps, accumulated spp

The HTTP handlers run on ThreadingHTTPServer's threads; a lock serialises
the renders, and every tensor the viewer makes names the renderer's
device (a CUDA device's index is fixed when the app is built, and each
render runs with it current).

Run:  python -m rtxpt_tpu_torch.app.viewer --scene programmer-art \\
          --port 8123 [--device cpu]
"""
from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>rtxpt_tpu_torch viewer</title><style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace;
      display:flex}
 #view{flex:1;display:flex;align-items:center;justify-content:center}
 canvas{image-rendering:pixelated;outline:none}
 #panel{width:240px;padding:10px;background:#1a1a1f;overflow-y:auto}
 #panel label{display:block;margin:6px 0 2px}
 #panel select,#panel input{width:100%;box-sizing:border-box}
 #stats{white-space:pre;color:#8c8;margin-top:8px}
 button{margin-top:8px;width:100%}
</style></head><body>
<div id=view><canvas id=c tabindex=1></canvas></div>
<div id=panel>
 <b>rtxpt_tpu_torch</b>
 <label>mode</label>
 <select id=mode><option>realtime</option><option>reference</option>
 </select>
 <label>debug view</label><select id=dbg><option>none</option></select>
 <label>max bounces</label>
 <input id=bounces type=number min=1 max=30 value=30>
 <label><input id=sp type=checkbox checked style="width:auto">
  stable planes</label>
 <label><input id=den type=checkbox checked style="width:auto">
  denoiser</label>
 <label>denoiser method</label>
 <select id=denm><option>relax</option><option>reblur</option></select>
 <label>exposure</label>
 <input id=exp type=range min=-4 max=4 step=0.1 value=0>
 <hr><b>material editor</b>
 <label>material</label><select id=mat></select>
 <label>base color</label><input id=mbc type=color value="#cccccc">
 <label>roughness <span id=mrv></span></label>
 <input id=mr type=range min=0 max=1 step=0.01>
 <label>metalness <span id=mmv></span></label>
 <input id=mm type=range min=0 max=1 step=0.01>
 <label>emissive scale <span id=mev></span></label>
 <input id=me type=range min=0 max=20 step=0.1>
 <button id=shot>screenshot</button>
 <div id=stats></div>
 <div style="margin-top:8px;color:#777">WASD/QE move &middot; drag to
  look &middot; shift = fast</div>
</div>
<script>
const c=document.getElementById('c'),ctx=c.getContext('2d');
const keys={},st=document.getElementById('stats');
let dragging=false,dx=0,dy=0,busy=false;
c.addEventListener('keydown',e=>keys[e.key.toLowerCase()]=1);
c.addEventListener('keyup',e=>delete keys[e.key.toLowerCase()]);
c.addEventListener('mousedown',()=>{dragging=true;c.focus();});
window.addEventListener('mouseup',()=>dragging=false);
window.addEventListener('mousemove',e=>{
  if(dragging){dx+=e.movementX;dy+=e.movementY;}});
function cfg(){return{
  mode:mode.value,debug_view:dbg.value,max_bounces:+bounces.value,
  stable_planes:sp.checked,denoiser:den.checked,
  denoiser_method:denm.value,exposure:Math.pow(2,+exp.value)};}
for(const id of['mode','dbg','bounces','sp','den','denm'])
  document.getElementById(id).addEventListener('change',()=>{
    fetch('/api/config',{method:'POST',body:JSON.stringify(cfg())});});
document.getElementById('shot').onclick=()=>fetch('/api/screenshot',
  {method:'POST'});
let mats=[];
function hex(c){return '#'+c.map(v=>Math.round(Math.pow(
  Math.min(Math.max(v,0),1),1/2.2)*255).toString(16).padStart(2,'0'))
  .join('');}
function unhex(h){return [1,3,5].map(i=>Math.pow(
  parseInt(h.substr(i,2),16)/255,2.2));}
function showMat(){const m=mats[mat.selectedIndex];if(!m)return;
  mbc.value=hex(m.base_color);mr.value=m.roughness;mm.value=m.metalness;
  me.value=Math.max(...m.emissive);
  mrv.textContent=m.roughness.toFixed(2);
  mmv.textContent=m.metalness.toFixed(2);
  mev.textContent=(+me.value).toFixed(1);}
function pushMat(){const m=mats[mat.selectedIndex];if(!m)return;
  m.base_color=unhex(mbc.value);m.roughness=+mr.value;
  m.metalness=+mm.value;
  const e0=Math.max(...m.emissive,1e-6),s=+me.value;
  m.emissive=m.emissive.map(v=>e0>1e-6?v/e0*s:s);
  mrv.textContent=(+mr.value).toFixed(2);
  mmv.textContent=(+mm.value).toFixed(2);
  mev.textContent=s.toFixed(1);
  fetch('/api/material',{method:'POST',body:JSON.stringify(m)});}
mat.addEventListener('change',showMat);
for(const id of['mbc','mr','mm','me'])
  document.getElementById(id).addEventListener('change',pushMat);
fetch('/api/state').then(r=>r.json()).then(s=>{
  c.width=s.width;c.height=s.height;
  for(const v of s.debug_views){const o=document.createElement('option');
    o.textContent=v;dbg.appendChild(o);}
  mats=s.materials||[];
  for(const m of mats){const o=document.createElement('option');
    o.textContent=m.index+': '+m.name;mat.appendChild(o);}
  showMat();loop();});
async function loop(){
  if(busy)return;busy=true;
  const inp={keys:Object.keys(keys),dx:dx,dy:dy,
             fast:!!keys['shift']};dx=0;dy=0;
  try{
    const r=await fetch('/api/frame',{method:'POST',
      body:JSON.stringify(inp)});
    st.textContent=decodeURIComponent(r.headers.get('x-stats')||'');
    const b=await r.blob();
    const img=await createImageBitmap(b);
    ctx.drawImage(img,0,0);
  }catch(e){st.textContent='disconnected';}
  busy=false;setTimeout(loop,5);}
</script></body></html>"""


class ViewerApp:
    """Owns the renderer and the camera state; one render at a time."""

    def __init__(self, host_scene, camera, width, height, env=None,
                 analytic_lights=None, realtime_overrides=None,
                 device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.host = host_scene
        self.env = env
        self.analytic = analytic_lights
        self.width, self.height = width, height
        self.lock = threading.Lock()
        self.exposure = 1.0
        self.debug_view = "none"
        self.screenshot_path = "viewer_screenshot.png"
        self.settings = dict(mode="realtime", max_bounces=30,
                             stable_planes=True, denoiser=True,
                             denoiser_method="relax")
        if realtime_overrides:
            self.settings.update(realtime_overrides)
        # fly-camera state from the initial camera (FirstPersonCamera)
        pos = camera.pos.cpu().numpy()
        d = camera.direction.cpu().numpy()
        self.eye = pos.astype(np.float64)
        self.yaw = math.atan2(d[0], -d[2])
        self.pitch = math.asin(float(np.clip(d[1], -1, 1)))
        self.moved = True
        self.frame_ms = 0.0
        self._last_srgb = None
        self._renderer = None
        with self._on_device():
            self._build_renderer()

    def _on_device(self):
        """The renderer's CUDA device made current in the calling thread
        (a no-op on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ---- camera -----------------------------------------------------
    def _camera(self):
        from ..scene.camera import make_camera
        cp, sy, cy = math.cos(self.pitch), math.sin(self.yaw), \
            math.cos(self.yaw)
        look = (cp * sy, math.sin(self.pitch), -cp * cy)
        return make_camera(self.width, self.height, tuple(self.eye),
                           look).to(self.device)

    def apply_input(self, keys, dx, dy, fast=False):
        """WASD/QE + mouse deltas -> camera motion (Donut
        FirstPersonCamera:KeyboardUpdate/MouseMoveUpdate)."""
        speed = (0.35 if fast else 0.08)
        self.yaw += dx * 0.005
        self.pitch = float(np.clip(self.pitch - dy * 0.005, -1.5, 1.5))
        cp, sy, cy = math.cos(self.pitch), math.sin(self.yaw), \
            math.cos(self.yaw)
        fwd = np.asarray([cp * sy, math.sin(self.pitch), -cp * cy])
        right = np.asarray([cy, 0.0, sy])
        up = np.asarray([0.0, 1.0, 0.0])
        delta = np.zeros(3)
        for k, v in (("w", fwd), ("s", -fwd), ("d", right),
                     ("a", -right), ("e", up), ("q", -up)):
            if k in keys:
                delta = delta + v
        if dx or dy or delta.any():
            self.eye = self.eye + delta * speed
            self.moved = True

    # ---- renderer lifecycle -----------------------------------------
    def _build_renderer(self):
        from ..models.realtime import RealtimeRenderer
        from ..models.renderer import (Renderer, realtime_config,
                                       reference_config)
        s = self.settings
        if s["mode"] == "realtime":
            cfg = realtime_config(
                max_bounces=int(s["max_bounces"]),
                use_restir_di=True, use_restir_gi=True,
                denoiser_enabled=bool(s["denoiser"]),
                denoiser_method=s["denoiser_method"],
                use_stable_planes=bool(s["stable_planes"]),
                nee_distant_samples=1, nee_local_samples=1)
            cls = RealtimeRenderer
        else:
            cfg = reference_config(max_bounces=int(s["max_bounces"]))
            cls = Renderer
        self._renderer = cls(self.host, self._camera(), cfg,
                             env_radiance=self.env,
                             analytic_lights=self.analytic,
                             device=self.device)
        self.moved = True

    def set_config(self, new):
        """Settings-panel change; the renderer is rebuilt under the lock
        when a renderer setting changed."""
        with self.lock, self._on_device():
            self.exposure = float(new.pop("exposure", self.exposure))
            self.debug_view = new.pop("debug_view", self.debug_view)
            changed = {k: v for k, v in new.items()
                       if k in self.settings and self.settings[k] != v}
            if changed:
                self.settings.update(changed)
                self._build_renderer()

    # ---- frame ------------------------------------------------------
    def render_frame(self):
        """One frame of the current mode, or the debug view: (sRGB (H,W,3)
        numpy, stats text). frame_ms ends with the copy to the host, so it
        times a finished frame."""
        from ..post.tonemap import tonemap
        from ..utils import debugviews as DV
        with self.lock, self._on_device():
            t0 = time.time()
            cam = self._camera()
            r = self._renderer
            if self.debug_view != "none":
                hdr = DV.render_debug_view(
                    self.debug_view, r.assets, cam, self.width, self.height,
                    frame_outputs=getattr(r, "last_outputs", None),
                    stable_planes=getattr(r, "last_stable_planes", None),
                    plane_radiance=getattr(r, "last_plane_radiance", None),
                    plane_denoised=getattr(r, "last_plane_denoised", None),
                    den_states=getattr(r, "den_states", None))
                srgb = torch.clamp(hdr, 0.0, 1.0).cpu().numpy()
                stats = f"debug:{self.debug_view}"
            elif self.settings["mode"] == "realtime":
                img = r.render_frame(self.width, self.height, camera=cam)
                srgb = tonemap(img, exposure=self.exposure).cpu().numpy()
                stats = f"{self.frame_ms:6.1f} ms/frame " \
                    f"({1e3 / max(self.frame_ms, 1e-3):5.1f} fps)"
            else:
                if self.moved:
                    r.camera = cam
                    r.reset_accumulation()
                r.render(self.width, self.height, 1)
                srgb = tonemap(r.accum, exposure=self.exposure).cpu().numpy()
                stats = f"{self.frame_ms:6.1f} ms/sample   " \
                    f"{r.sample_index} spp"
            self.moved = False
            self.frame_ms = (time.time() - t0) * 1e3
            self._last_srgb = srgb
            return srgb, stats

    def set_material(self, edit: dict):
        """Material-editor change (SampleUI.cpp:1254,1382): the running
        renderer's material row is rewritten on its device, with no
        rebuild. Reference mode restarts accumulation (the reference
        resets on material edits too)."""
        with self.lock, self._on_device():
            self._renderer.set_material(
                int(edit["index"]),
                base_color=edit.get("base_color"),
                roughness=edit.get("roughness"),
                metalness=edit.get("metalness"),
                emissive=edit.get("emissive"))
            if self.settings["mode"] == "reference":
                self.moved = True     # restart accumulation

    def state(self):
        from ..utils import debugviews as DV
        with self.lock, self._on_device():
            materials = self._renderer.material_info()
        return dict(width=self.width, height=self.height,
                    settings=self.settings,
                    debug_views=list(DV.VIEWS), materials=materials)


class _Handler(BaseHTTPRequestHandler):
    app: ViewerApp = None

    def log_message(self, *a):            # quiet server
        pass

    def _send(self, code, body, ctype="application/json", hdrs=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in hdrs:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        ln = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(ln) if ln else b"{}"
        try:
            return json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return {}

    def do_GET(self):
        if self.path == "/":
            self._send(200, _PAGE.encode(), "text/html")
        elif self.path == "/api/state":
            self._send(200, json.dumps(self.app.state()).encode())
        else:
            self._send(404, b"{}")

    def do_POST(self):
        from urllib.parse import quote

        from ..utils import image as IM
        app = self.app
        if self.path == "/api/frame":
            inp = self._body()
            app.apply_input(set(inp.get("keys") or ()),
                            float(inp.get("dx") or 0.0),
                            float(inp.get("dy") or 0.0),
                            bool(inp.get("fast")))
            srgb, stats = app.render_frame()
            png = IM.encode_png_bytes(srgb)
            self._send(200, png, "image/png",
                       hdrs=[("X-Stats", quote(stats))])
        elif self.path == "/api/config":
            app.set_config(self._body())
            self._send(200, b"{}")
        elif self.path == "/api/material":
            app.set_material(self._body())
            self._send(200, b"{}")
        elif self.path == "/api/screenshot":
            last = app._last_srgb
            IM.save_png(app.screenshot_path,
                        np.zeros((1, 1, 3)) if last is None else last)
            self._send(200, json.dumps(
                {"saved": app.screenshot_path}).encode())
        else:
            self._send(404, b"{}")


def serve(app: ViewerApp, port: int = 0):
    """Start the viewer server on 127.0.0.1 on a daemon thread; returns
    (server, thread). port=0 picks a free port (server.server_address[1]);
    stop it with server.shutdown() and server.server_close()."""
    handler = type("BoundHandler", (_Handler,), {"app": app})
    srv = ThreadingHTTPServer(("127.0.0.1", port), handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th


def main(argv=None) -> int:
    import argparse
    from .cli import load_scene

    p = argparse.ArgumentParser("rtxpt_tpu_torch interactive viewer")
    p.add_argument("--scene", default="programmer-art")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--port", type=int, default=8123)
    p.add_argument("--sky-scale", type=float, default=1.0)
    p.add_argument("--env", default=None)
    p.add_argument("--diffuse-only", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernels, "
                   "'cpu' their plain PyTorch versions")
    args = p.parse_args(argv)

    from ..scene import envmap as EM
    host, cam, extra = load_scene(args)
    env = extra.get("env_radiance")
    if args.env:
        env = EM.load_equirect(args.env)
    if env is None:
        env = EM.bake_procedural_sky(sky_scale=args.sky_scale)
    app = ViewerApp(host, cam, args.width, args.height, env=env,
                    analytic_lights=extra.get("analytic_lights"),
                    device=args.device)
    srv, _ = serve(app, args.port)
    print(f"viewer: http://127.0.0.1:{srv.server_address[1]}/ "
          f"({args.width}x{args.height} on {app.device})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.shutdown()
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
