"""Live web viewer: the mission in a browser (port of
`activegs_tpu/viz/webviewer.py`).

A small HTTP server in a daemon thread serves the latest keyframe's channel
panel, the voxel top view, the scene overlay and the mission's stats, and
renders a fly-cam view on request: the browser posts pose offsets
(WASD / arrows), a channel (rgb / depth / confidence / opacity / normal /
d2n), a confidence threshold and a scale factor, and the server renders
that view of the live map on the mapper's device (so the forward kernel on
the card). Images are PNGs from `io/png.py`.

The fly-cam renders on the server's thread. `on_step` keeps the map's
activated attributes as of that step, and a lock shared by `on_step` and
the renders keeps a render from reading them while a step replaces them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..io.png import png_bytes
from ..mapping import gaussians as gm
from ..render.renderer import render_view
from ..render.types import Camera
from .viewer import _colormap, _np, channel_images, render_channel_panel, scene_overlay, voxel_top_view

_PAGE = """<!DOCTYPE html>
<html><head><title>active-gs live viewer</title>
<style>
 body { background: #111; color: #ddd; font-family: monospace; margin: 1em; }
 img { image-rendering: pixelated; border: 1px solid #333; }
 #stats { white-space: pre; color: #8c8; }
 button { margin: 2px; }
</style></head>
<body>
<h3>active-gs live viewer</h3>
<div id="stats">waiting for mission...</div>
<div>
 <b>latest keyframe panel</b> (rgb | depth | conf / opac | normal | d2n)<br>
 <img id="panel" src="/panel.png" width="768">
</div>
<div style="display:flex; gap:2em">
 <div><b>voxel top view</b><br><img id="voxel" src="/voxel.png" width="320"></div>
 <div><b>scene overlay</b> (exec path | planned | candidates | NBV | frustum)<br>
  <img id="scene" src="/scene.png" width="320"></div>
 <div><b>fly-cam</b> (click image, then WASD move / arrows rotate / QE up-down)<br>
  <img id="fly" src="/fly.png" width="384" tabindex="0"><br>
  channel: <select id="chan">
   <option>rgb</option><option>depth</option><option>confidence</option>
   <option>opacity</option><option>normal</option><option>d2n</option>
  </select>
  <button onclick="resetFly()">reset pose</button><br>
  conf &ge; <input type="range" id="confmin" min="0" max="1" step="0.05"
   value="0" style="width:100px">
  scale &times; <input type="range" id="scalemod" min="0.1" max="2" step="0.1"
   value="1" style="width:100px"><span id="svals"></span><br>
  <button onclick="fetch('/record_pose'+flyUrl().slice(8)).then(r=>r.json())
    .then(s=>{document.getElementById('rec').textContent=s.count+' recorded';})">
    record pose</button>
  <a href="/poses.json" style="color:#8c8" id="rec">0 recorded</a>
 </div>
</div>
<script>
let dx=0, dy=0, dz=0, yaw=0, pitch=0;
function resetFly(){ dx=dy=dz=yaw=pitch=0; refreshFly(); }
function flyUrl(){
  const cm = document.getElementById('confmin').value;
  const sm = document.getElementById('scalemod').value;
  document.getElementById('svals').textContent = ` (${cm} / ${sm})`;
  return `/fly.png?dx=${dx}&dy=${dy}&dz=${dz}&yaw=${yaw}&pitch=${pitch}` +
         `&conf_min=${cm}&scale_mod=${sm}` +
         `&chan=${document.getElementById('chan').value}&t=${Date.now()}`;
}
document.getElementById('confmin').addEventListener('change', refreshFly);
document.getElementById('scalemod').addEventListener('change', refreshFly);
function refreshFly(){ document.getElementById('fly').src = flyUrl(); }
document.getElementById('fly').addEventListener('keydown', (e) => {
  const s = 0.15, r = 0.1;
  if (e.key === 'w') dz += s; if (e.key === 's') dz -= s;
  if (e.key === 'a') dx -= s; if (e.key === 'd') dx += s;
  if (e.key === 'q') dy -= s; if (e.key === 'e') dy += s;
  if (e.key === 'ArrowLeft') yaw -= r; if (e.key === 'ArrowRight') yaw += r;
  if (e.key === 'ArrowUp') pitch -= r; if (e.key === 'ArrowDown') pitch += r;
  refreshFly(); e.preventDefault();
});
document.getElementById('chan').addEventListener('change', refreshFly);
setInterval(() => {
  document.getElementById('panel').src = '/panel.png?t=' + Date.now();
  document.getElementById('voxel').src = '/voxel.png?t=' + Date.now();
  document.getElementById('scene').src = '/scene.png?t=' + Date.now();
  fetch('/stats.json').then(r => r.json()).then(s => {
    document.getElementById('stats').textContent = JSON.stringify(s, null, 1);
  });
}, 2000);
</script>
</body></html>
"""


def _filter_attrs(attrs, conf_min: float, scale_mod: float):
    """The fly-cam's render filter: hide the gaussians below the confidence
    threshold, scale every surfel by the slider's factor."""
    return dataclasses.replace(attrs, valid=attrs.valid & (attrs.confidences >= conf_min), scales=attrs.scales * scale_mod)


class WebViewer:
    """A mapper's `viewer`: `on_step` keeps the latest panels and the map's
    attributes; the server serves them and renders fly-cam views on
    demand. `port=0` takes a free port (`self.port`)."""

    def __init__(self, port: int = 8787, shape=(256, 256), host: str = "127.0.0.1"):
        self.shape = shape
        self._lock = threading.Lock()
        self._panel: bytes | None = None
        self._voxel: bytes | None = None
        self._scene: bytes | None = None
        self._stats: dict = {}
        self._exec_path: list = []
        self._poses: list = []  # recorded fly-cam poses (4x4 lists)
        self._attrs = None
        self._raster_cfg = None
        self._base_pose: np.ndarray | None = None
        self._intrinsic = None
        self._depth_range = (0.0, 5.0)

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _image(self, img, missing: bytes):
                if img is None:
                    self._send(404, "text/plain", missing)
                else:
                    self._send(200, "image/png", img)

            def do_GET(self):
                try:
                    url = urlparse(self.path)
                    q = {k: v[0] for k, v in parse_qs(url.query).items()}
                    if url.path == "/":
                        self._send(200, "text/html", _PAGE.encode())
                    elif url.path == "/stats.json":
                        with viewer._lock:
                            body = json.dumps(viewer._stats).encode()
                        self._send(200, "application/json", body)
                    elif url.path in ("/panel.png", "/voxel.png", "/scene.png"):
                        name = url.path[1:-4]
                        with viewer._lock:
                            img = getattr(viewer, f"_{name}")
                        self._image(img, f"no {name} view yet".encode())
                    elif url.path == "/fly.png":
                        self._image(viewer._render_fly(q), b"mission not started")
                    elif url.path == "/record_pose":
                        # the current fly-cam pose joins a downloadable list
                        n = viewer._record_pose(q)
                        if n is None:
                            self._send(404, "text/plain", b"mission not started")
                        else:
                            self._send(200, "application/json", json.dumps({"count": n}).encode())
                    elif url.path == "/poses.json":
                        with viewer._lock:
                            body = json.dumps(viewer._poses).encode()
                        self._send(200, "application/json", body)
                    else:
                        self._send(404, "text/plain", b"not found")
                except BrokenPipeError:
                    pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    # ---- mapper hook ----

    @torch.no_grad()
    def on_step(self, mapper, frame, path, stats) -> None:
        cam = Camera(extrinsic=frame["extrinsic"], intrinsic=frame["intrinsic"])
        depth_range = tuple(_np(frame["depth_range"]).tolist())
        self._exec_path.append(_np(frame["extrinsic"])[:3, 3].astype(np.float32))
        planner = mapper.planner
        with self._lock:
            panel = render_channel_panel(
                mapper.gm_state, mapper.map_cfg, cam, self.shape, mapper.raster_cfg, depth_range=depth_range
            )
            top = voxel_top_view(mapper.vm_state, mapper.grid, mapper.voxel_cfg)
            scene = scene_overlay(
                mapper.vm_state,
                mapper.grid,
                mapper.voxel_cfg,
                exec_path=np.stack(self._exec_path),
                planned_path=np.asarray(path) if path is not None else None,
                candidates=getattr(planner, "last_candidates", None),
                nbv=getattr(planner, "last_nbv", None),
                camera=cam,
            )
            self._attrs = gm.attrs_of(mapper.gm_state, mapper.map_cfg)
            self._raster_cfg = mapper.raster_cfg
            self._base_pose = _np(frame["extrinsic"]).astype(np.float32)
            self._intrinsic = frame["intrinsic"]
            self._depth_range = depth_range
            self._panel = png_bytes(panel)
            self._voxel = png_bytes(top)
            self._scene = png_bytes(scene)
            self._stats = dict(stats)

    # ---- fly-cam ----

    def _fly_pose(self, q: dict) -> np.ndarray | None:
        """The fly-cam extrinsic from the query's pose offsets (None before
        the first step)."""
        with self._lock:
            base = self._base_pose
        if base is None:
            return None
        dx, dy, dz = (float(q.get(k, 0)) for k in ("dx", "dy", "dz"))
        yaw, pitch = float(q.get("yaw", 0)), float(q.get("pitch", 0))
        ext = base.copy()
        # camera-frame translation (x right, y down, z forward: OpenCV)
        ext[:3, 3] += ext[:3, :3] @ np.array([dx, dy, dz], np.float32)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
        ext[:3, :3] = ext[:3, :3] @ ry @ rx
        return ext

    def _record_pose(self, q: dict) -> int | None:
        ext = self._fly_pose(q)
        if ext is None:
            return None
        with self._lock:
            self._poses.append(np.asarray(ext, np.float64).tolist())
            return len(self._poses)

    @torch.no_grad()
    def _render_fly(self, q: dict) -> bytes | None:
        ext = self._fly_pose(q)
        if ext is None:
            return None
        chan = q.get("chan", "rgb")
        conf_min, scale_mod = float(q.get("conf_min", 0)), float(q.get("scale_mod", 1))
        with self._lock:
            attrs, intr, depth_range = self._attrs, self._intrinsic, self._depth_range
            dev = attrs.means.device
            if conf_min > 0 or scale_mod != 1.0:
                attrs = _filter_attrs(attrs, conf_min, scale_mod)
            cam = Camera(extrinsic=torch.as_tensor(ext, device=dev), intrinsic=intr)
            # the server's thread has its own current device
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                out, _ = render_view(attrs, cam, self.shape, self._raster_cfg)
                ch = channel_images(out, intr)
        chan = chan if chan in ch else "rgb"
        img = {
            "depth": lambda x: _colormap(x, *depth_range),
            "confidence": lambda x: _colormap(x, 0, 1),
            "opacity": lambda x: _colormap(x, 0, 1),
            "normal": lambda x: 0.5 * (x + 1.0),
            "d2n": lambda x: 0.5 * (x + 1.0),
        }.get(chan, lambda x: x)(ch[chan])
        return png_bytes((np.clip(img, 0, 1) * 255).astype(np.uint8))

    def close(self):
        self._server.shutdown()
        self._server.server_close()
