"""Live interactive viewer: the counterpart of the reference's OpenGL
window (display loop nbody_v5.cu:327-356, mouse and reshape callbacks
:459-473, 1280x720 window :385-389), served over HTTP.

  * A sim thread advances the simulation and renders each frame on the
    simulation's device (viz/render.render_frame), quantises it to uint8
    there, and JPEG-encodes the previous frame on the host while the
    device works on the next.
  * A stdlib HTTP server serves
      /           an HTML page with the stream and the mouse handlers
      /stream     multipart/x-mixed-replace MJPEG (live video)
      /frame.jpg  the latest frame
      /cam        POST {drag_dx, drag_dy} | {scroll} | {reset}
      /stats      JSON: step count, ms/step, camera
  * Browser mouse events map as the GLUT callbacks did: a drag rotates
    0.2 deg per pixel, a wheel click zooms by 150.

Run:  python -m nbody_tpu_torch view --preset v5 --port 8089
then open http://localhost:8089/ (ssh -L 8089:localhost:8089 if remote).
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.viz.render import OrbitCamera, render_frame

_PAGE = """<!doctype html>
<html><head><title>nbody_tpu_torch</title><style>
  body { margin:0; background:#000; color:#9af; font:12px monospace; overflow:hidden }
  #hud { position:fixed; top:6px; left:8px; pointer-events:none; white-space:pre }
  img  { display:block; width:100vw; height:100vh; object-fit:contain; cursor:grab }
</style></head><body>
<img id="v" src="/stream" draggable="false">
<div id="hud"></div>
<script>
const v = document.getElementById('v'), hud = document.getElementById('hud');
let drag = null;
const post = (b) => fetch('/cam', {method:'POST', body: JSON.stringify(b)});
v.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  post({drag_dx: dx, drag_dy: dy});               // 0.2 deg/px server-side
});
window.addEventListener('wheel', e => { post({scroll: e.deltaY < 0 ? 1 : -1}); });
window.addEventListener('keydown', e => { if (e.key == 'r') post({reset: 1}); });
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  hud.textContent = `n=${s.n}  step ${s.step}  ${s.ms_per_step.toFixed(1)} ms/step  ` +
    `dist ${s.distance.toFixed(0)}  rot ${s.rot_x.toFixed(0)}/${s.rot_y.toFixed(0)}  [drag|wheel|r]`;
}, 500);
</script></body></html>"""


def encode_jpeg(img: np.ndarray, quality: int = 85) -> bytes:
    """JPEG bytes of an [H, W, 3] uint8 image (PIL)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class SimViewer:
    """Owns the sim thread, the camera and the latest JPEG frame.  An
    exception in the sim thread stops it; wait_frame() and stop() raise
    it."""

    def __init__(self, sim, state, cfg: SimConfig, mode: str = "add",
                 exposure: float = 1.0, steps_per_frame: int = 1,
                 jpeg_quality: int = 85):
        self.sim = sim
        self.state = state
        self.cfg = cfg
        self.device = state.device
        self.mode = mode
        self.exposure = exposure
        self.steps_per_frame = max(1, steps_per_frame)
        self.jpeg_quality = jpeg_quality
        self.camera = OrbitCamera(cfg)
        # the adaptive runner's persistent stepper keeps the band
        # structures across frames, so a frame rebuilds only when the
        # physics asks, and hands the renderer its Morton-ordered
        # buffers with no scatter back a frame; None for configurations
        # without reusable bands
        self._stepper = sim.make_stepper(state)
        self.step_count = 0
        self.frames = 0
        self.ms_per_step = 0.0
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()          # camera and stats
        self._jpeg: bytes = b""
        self._new = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_pub = 0.0

    # --- sim side -------------------------------------------------------
    def _frame(self):
        """Advance, render and quantise one frame; returns (uint8 frame,
        completion event or None)."""
        if self._stepper is not None:
            self._stepper.advance(self.steps_per_frame)
            # Morton-ordered arrays straight from the stepper (pad rows
            # clone the last particle): no scatter back per frame
            pos, vel = self._stepper.pos_sorted, self._stepper.vel_sorted
        else:
            self.state = self.sim.run_scan(self.state, self.steps_per_frame)
            pos, vel = self.state.pos, self.state.vel
        with self._lock:
            d, rx, ry = (self.camera.distance, self.camera.rot_x,
                         self.camera.rot_y)
        frame = render_frame(pos, vel, d, rx, ry, self.cfg.render_width,
                             self.cfg.render_height, self.mode, self.exposure)
        # quantise on the device: the host fetch moves 1 byte per channel
        q = torch.clamp(frame * 255.0, 0.0, 255.0).to(torch.uint8)
        if q.device.type != "cuda":
            return q, None
        # copy into pinned memory behind the frame's work on the stream,
        # so fetching it waits for this frame and not for the next one
        host = torch.empty(q.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(q, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _loop(self) -> None:
        # depth-1 pipeline: enqueue frame k+1's device work, then fetch
        # and encode frame k on the host
        try:
            with (torch.cuda.device(self.device)
                  if self.device.type == "cuda" else contextlib.nullcontext()):
                pending = None
                self._last_pub = time.perf_counter()
                while not self._stop.is_set():
                    nxt = self._frame()
                    if pending is not None:
                        self._publish(*pending)
                    pending = nxt
                if pending is not None:
                    self._publish(*pending)
        except Exception as e:                 # raised by wait_frame and stop
            self.error = e
            with self._new:
                self._new.notify_all()

    def _publish(self, host: torch.Tensor, done) -> None:
        if done is not None:
            done.synchronize()
        data = encode_jpeg(host.numpy(), self.jpeg_quality)
        now = time.perf_counter()
        dt_ms = (now - self._last_pub) * 1e3 / self.steps_per_frame
        self._last_pub = now
        with self._lock:
            self.step_count += self.steps_per_frame
            self.frames += 1
            self.ms_per_step = dt_ms
        with self._new:
            self._jpeg = data
            self._new.notify_all()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the sim thread, fold the stepper's progress back into
        .state (original particle order) and raise the thread's error, if
        any."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError("the sim thread did not stop in 60 s")
        if self.error is not None:
            raise RuntimeError("the sim thread failed") from self.error
        if self._stepper is not None:
            self.state = self._stepper.snapshot()

    # --- HTTP side ------------------------------------------------------
    def wait_frame(self, timeout: float = 60.0) -> bytes:
        """The latest encoded frame, waiting up to `timeout` s for the
        first; raises if the sim thread failed."""
        with self._new:
            if not self._jpeg and self.error is None:
                self._new.wait(timeout)
            if self.error is not None:
                raise RuntimeError("the sim thread failed") from self.error
            return self._jpeg

    def apply_cam(self, msg: dict) -> None:
        with self._lock:
            if msg.get("reset"):
                self.camera = OrbitCamera(self.cfg)
            if "drag_dx" in msg or "drag_dy" in msg:
                self.camera.drag(float(msg.get("drag_dx", 0.0)),
                                 float(msg.get("drag_dy", 0.0)))
            if "scroll" in msg:
                self.camera.scroll(int(msg["scroll"]))
            # keep the camera outside the cloud and in front of near=10
            self.camera.distance = float(
                np.clip(self.camera.distance, 50.0, 5.0e5))

    def stats(self) -> dict:
        with self._lock:
            return {
                "n": self.cfg.n,
                "step": self.step_count,
                "frames": self.frames,
                "ms_per_step": self.ms_per_step,
                "distance": self.camera.distance,
                "rot_x": self.camera.rot_x,
                "rot_y": self.camera.rot_y,
            }


def make_handler(viewer: SimViewer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, "text/html", _PAGE.encode())
            elif self.path.startswith("/frame.jpg"):
                try:
                    frame = viewer.wait_frame()
                except RuntimeError as e:
                    self._send(500, "text/plain", str(e).encode())
                    return
                self._send(200, "image/jpeg", frame)
            elif self.path.startswith("/stats"):
                self._send(200, "application/json",
                           json.dumps(viewer.stats()).encode())
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    while not viewer._stop.is_set() and viewer.error is None:
                        with viewer._new:
                            viewer._new.wait(5.0)
                            jpeg = viewer._jpeg
                        if not jpeg:
                            continue
                        self.wfile.write(b"--frame\r\n")
                        self.wfile.write(b"Content-Type: image/jpeg\r\n")
                        self.wfile.write(
                            f"Content-Length: {len(jpeg)}\r\n\r\n".encode())
                        self.wfile.write(jpeg)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path.startswith("/cam"):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    msg = {}
                viewer.apply_cam(msg)
                self._send(200, "application/json", b"{}")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def serve(viewer: SimViewer, port: int = 8089, host: str = "127.0.0.1"
          ) -> ThreadingHTTPServer:
    """Start the HTTP server in a daemon thread and return it (port 0:
    the OS picks one, see .server_address); call .shutdown() and
    .server_close() to stop it."""
    server = ThreadingHTTPServer((host, port), make_handler(viewer))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
