"""Localhost interactive viewer over the offscreen render loop.

The reference is an interactive GLFW/ImGui application
(src/Renderer.cpp:239-766).  A headless accelerator host has no display; the
interactive capability is provided as a tiny HTTP viewer instead: a
single-page canvas app that drag-orbits the camera (the OrbitControls
yaw/pitch/radius model, include/OrbitControls.h) and fetches freshly
rendered PNG frames from the offscreen loop.  Method switching and the
Debug toggles (colorize modes, LOD slider) are exposed as query
parameters — the ImGui panel's role.

The HUD also shows live per-phase frame timings (min/avg/max rows from
engine/timing.Timings, polled from /timings) — the reference's
scrolling perf plot + timing table (src/Renderer.cpp:371-459).

Run:  python -m pcrhpg24_tpu.app --scene scene.tpc --serve 8000
then open http://localhost:8000/
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>pcrhpg24-tpu viewer</title><style>
 body{margin:0;background:#111;color:#ccc;font:13px monospace}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px}
 #tm{position:fixed;top:8px;right:8px;background:#000a;padding:6px 10px;
     white-space:pre;text-align:right}
 img{display:block;width:100vw;height:100vh;object-fit:contain;
     image-rendering:pixelated}
</style></head><body>
<div id="hud">drag: orbit &middot; wheel: zoom &middot; keys: m method,
 c chunks, o overdraw, e EDL &middot; <span id="st"></span></div>
<div id="tm"></div>
<img id="v">
<script>
let yaw=0.5,pitch=-0.7,radius=null,mi=0,mode="",edl=0;
let dragging=false,lx=0,ly=0,busy=false,dirty=true;
const img=document.getElementById("v"),st=document.getElementById("st");
fetch("/info").then(r=>r.json()).then(j=>{radius=j.radius;loop();});
function url(){return `/frame?yaw=${yaw}&pitch=${pitch}&radius=${radius}`+
  `&method=${mi}&mode=${mode}&edl=${edl}`;}
const tm=document.getElementById("tm");
async function pollT(){try{const j=await(await fetch("/timings")).json();
  tm.textContent=j.rows.map(r=>`${r.label.padEnd(10)} `+
    `${r.min.toFixed(1)}/${r.avg.toFixed(1)}/${r.max.toFixed(1)} ms`)
    .join("\n");}catch(e){}setTimeout(pollT,800);}
pollT();
async function loop(){
  if(dirty&&!busy){busy=true;dirty=false;const t0=performance.now();
    const r=await fetch(url());const b=await r.blob();
    img.src=URL.createObjectURL(b);
    st.textContent=r.headers.get("x-method")+" "+
      (performance.now()-t0).toFixed(0)+" ms";busy=false;
    if(r.headers.get("x-stale")=="1")dirty=true;/* converge to pose */}
  requestAnimationFrame(loop);}
img.onmousedown=e=>{dragging=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>dragging=false;
window.onmousemove=e=>{if(!dragging)return;
  yaw-=(e.clientX-lx)*0.005;pitch-=(e.clientY-ly)*0.005;
  pitch=Math.max(-1.55,Math.min(1.55,pitch));
  lx=e.clientX;ly=e.clientY;dirty=true;};
window.onwheel=e=>{radius*=e.deltaY>0?1.15:0.87;dirty=true;};
window.onkeydown=e=>{
  if(e.key=="m"){mi++;dirty=true;}
  if(e.key=="c"){mode=mode=="chunks"?"":"chunks";dirty=true;}
  if(e.key=="o"){mode=mode=="overdraw"?"":"overdraw";dirty=true;}
  if(e.key=="e"){edl=1-edl;dirty=true;}};
</script></body></html>"""


class ViewerServer:
    """Serves the page + renders frames on demand (render thread = the
    HTTP handler thread; jax dispatch is internally threadsafe here
    because a lock serializes frames)."""

    def __init__(self, renderer, methods, port: int = 8000):
        self.renderer = renderer
        self.methods = methods
        self.port = port
        self._lock = threading.Lock()
        self._httpd: HTTPServer | None = None
        self._pending = None  # (key, device rgb8, method name)

    def render_png(self, params: dict) -> tuple[bytes, str, bool]:
        """One-frame-deep pipeline: dispatch THIS request's frame
        asynchronously, then serve the PREVIOUS dispatch's (already
        computing since the last request) — wall per frame while
        interacting is max(device frame, fetch RTT) + encode instead of
        their sum.  When parameters stop changing the pending frame
        matches the request and is served fresh (stale=False); the page
        re-fetches once whenever it got a stale frame, so the displayed
        image converges to the final pose.  (The reference's GL loop
        gets the same overlap from the driver's queued frames,
        Renderer.cpp:239-766.)"""
        from ..engine.debug import Debug
        from ..render.raster import image_to_rgb8
        from ..utils.png import write_png_bytes

        r = self.renderer
        c = r.controls
        c.yaw = float(params.get("yaw", [c.yaw])[0])
        c.pitch = float(params.get("pitch", [c.pitch])[0])
        c.radius = float(params.get("radius", [c.radius])[0])
        mi = int(params.get("method", ["0"])[0]) % len(self.methods)
        mode = params.get("mode", [""])[0]
        edl = params.get("edl", ["0"])[0] == "1"
        method = self.methods[mi]
        key = (c.yaw, c.pitch, c.radius, mi, mode, edl)
        with self._lock:
            old = (Debug.colorize_chunks, Debug.colorize_overdraw, Debug.edl)
            Debug.colorize_chunks = mode == "chunks"
            Debug.colorize_overdraw = mode == "overdraw"
            Debug.edl = edl
            try:
                img = r.loop(method.update, method.render, frames=1,
                             block=False)
                rgb_dev = image_to_rgb8(img)
            finally:
                (Debug.colorize_chunks, Debug.colorize_overdraw,
                 Debug.edl) = old
            prev, self._pending = self._pending, (key, rgb_dev, method.name)
            if prev is not None and prev[0] != key:
                rgb, name, stale = np.asarray(prev[1]), prev[2], True
            else:
                rgb, name, stale = np.asarray(rgb_dev), method.name, False
        return write_png_bytes(rgb, level=1), name, stale

    def serve_forever(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                try:
                    if u.path == "/":
                        body = _PAGE.encode()
                        ctype = "text/html"
                        headers = {}
                    elif u.path == "/info":
                        body = json.dumps({
                            "radius": viewer.renderer.controls.radius,
                            "methods": [m.name for m in viewer.methods],
                        }).encode()
                        ctype = "application/json"
                        headers = {}
                    elif u.path == "/timings":
                        t = viewer.renderer.timings
                        rows = [
                            dict(label=lbl, min=s.min, avg=s.avg,
                                 max=s.max, n=s.count)
                            for lbl, s in sorted(t.stats.items())
                        ]
                        body = json.dumps({"rows": rows}).encode()
                        ctype = "application/json"
                        headers = {}
                    elif u.path == "/frame":
                        body, name, stale = viewer.render_png(
                            parse_qs(u.query))
                        ctype = "image/png"
                        headers = {"x-method": name,
                                   "x-stale": "1" if stale else "0"}
                    else:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("content-type", ctype)
                    self.send_header("content-length", str(len(body)))
                    for k, v in headers.items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass
                except Exception as e:  # surface render errors to the client
                    self.send_error(500, str(e))

        self._httpd = HTTPServer(("127.0.0.1", self.port), Handler)
        print(f"viewer: http://127.0.0.1:{self.port}/")
        self._httpd.serve_forever()

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
