"""Live HTTP viewer: the reference's interactive GLFW window, headless.

The reference opens a 2400x1800 GLFW window, draws every frame, and maps
mouse drag / scroll onto a spherical orbit camera
(``kernel.cu:1016-1064, 1191-1282``). A headless machine has no display, so
the same capability is delivered as a tiny HTTP server:

- ``/``        an HTML page with the live view; arrow keys / mouse drag
               orbit the camera, wheel or +/- zoom — the reference's
               controls (drag-to-rotate, x1.1 / x0.9 wheel zoom,
               ``kernel.cu:1031-1040, 1016-1022``) mapped onto requests.
- ``/stream``  multipart/x-mixed-replace MJPEG of the latest rendered
               frame — additive-splat frames tonemapped and JPEG-encoded
               off the simulation thread.
- ``/control`` camera mutations (``op=orbit&dx=..&dy=..``, ``op=zoom&s=..``).
- ``/stats``   one JSON object (step, ms/step, body count).

Encoding happens on the writer thread, device-to-host copies overlap the
next simulation block — the step loop never blocks on a viewer (unlike
the reference, whose physics rate is tied to the render rate, quirk Q8).

Usage:  python -m n_body_problem_tpu_torch run --dataset 0 --serve 8000 \
            --render-every 50
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from n_body_problem_tpu_torch.render.image import to_host, tonemap

_PAGE = """<!doctype html>
<html><head><title>n_body_problem_tpu</title><style>
 body { margin:0; background:#000; color:#ccc; font:13px monospace;
        display:flex; flex-direction:column; align-items:center }
 img  { max-width:100vw; max-height:92vh }
 #bar { padding:4px }
</style></head><body>
<div id="bar">drag / arrows: orbit &nbsp; wheel / +-: zoom &nbsp;
 <span id="stats"></span></div>
<img id="v" src="/stream" draggable="false">
<script>
 const send = q => fetch('/control?' + q);
 let drag = null;
 const img = document.getElementById('v');
 img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
 window.addEventListener('mouseup', () => { drag = null; });
 window.addEventListener('mousemove', e => {
   if (!drag) return;
   send(`op=orbit&dx=${e.clientX - drag[0]}&dy=${e.clientY - drag[1]}`);
   drag = [e.clientX, e.clientY];
 });
 window.addEventListener('wheel', e => send(`op=zoom&s=${e.deltaY < 0 ? 1 : -1}`));
 window.addEventListener('keydown', e => {
   const k = e.key;
   if (k === 'ArrowLeft')  send('op=orbit&dx=-20&dy=0');
   if (k === 'ArrowRight') send('op=orbit&dx=20&dy=0');
   if (k === 'ArrowUp')    send('op=orbit&dx=0&dy=-20');
   if (k === 'ArrowDown')  send('op=orbit&dx=0&dy=20');
   if (k === '+' || k === '=') send('op=zoom&s=1');
   if (k === '-') send('op=zoom&s=-1');
 });
 setInterval(async () => {
   const r = await fetch('/stats'); const s = await r.json();
   document.getElementById('stats').textContent =
     `step ${s.step}  n=${s.n}  ${s.ms_per_step.toFixed(2)} ms/step`;
 }, 1000);
</script></body></html>"""


class LiveViewer:
    """Shared state + HTTP server; ``submit`` is non-blocking.

    The camera object is shared with the simulation loop: ``/control``
    requests mutate it under ``camera_lock``; the loop reads it when
    building the next frame's view-projection.
    """

    def __init__(self, port: int, camera, *, exposure: float = 1.0,
                 host: str = "127.0.0.1", jpeg_quality: int = 85):
        try:
            import PIL  # noqa: F401  (the encoder thread's JPEG writer)
        except ImportError as e:
            raise RuntimeError("the live viewer needs Pillow to encode its stream") from e
        self.camera = camera
        self.camera_lock = threading.Lock()
        self.exposure = exposure
        self.jpeg_quality = jpeg_quality
        self.stats = {"step": 0, "n": 0, "ms_per_step": 0.0}
        self._jpeg: bytes | None = None
        self._frame_no = 0
        self._cond = threading.Condition()
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._encoder = threading.Thread(target=self._encode_loop, daemon=True)
        self._encoder.start()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):  # noqa: N802 (stdlib API)
                url = urlparse(self.path)
                if url.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/stream":
                    viewer._serve_stream(self)
                elif url.path == "/control":
                    viewer._control(parse_qs(url.query))
                    self.send_response(204)
                    self.end_headers()
                elif url.path == "/stats":
                    body = json.dumps(viewer.stats).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._server_thread.start()

    # ------------------------------------------------------------- control
    def _control(self, q: dict) -> None:
        op = q.get("op", [""])[0]
        with self.camera_lock:
            if op == "orbit":
                self.camera.orbit(float(q.get("dx", ["0"])[0]),
                                  float(q.get("dy", ["0"])[0]))
            elif op == "zoom":
                self.camera.zoom(float(q.get("s", ["0"])[0]))

    # -------------------------------------------------------------- frames
    def submit(self, frame) -> None:
        """Queue a device/host float frame for encoding (drops when busy:
        the stream shows the latest frame, it is not an archive)."""
        try:
            self._q.put_nowait(frame)
        except queue.Full:
            pass

    def _encode_loop(self) -> None:
        from PIL import Image

        while True:
            frame = self._q.get()
            if frame is None:
                return
            try:
                img = tonemap(to_host(frame), exposure=self.exposure)
                img8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(img8).save(buf, "JPEG",
                                           quality=self.jpeg_quality)
            except Exception as e:  # keep serving; surface on stderr
                import sys

                print(f"live viewer: frame encode failed: {e!r}",
                      file=sys.stderr)
                continue
            with self._cond:
                self._jpeg = buf.getvalue()
                self._frame_no += 1
                self._cond.notify_all()

    def _serve_stream(self, handler) -> None:
        handler.send_response(200)
        handler.send_header(
            "Content-Type", "multipart/x-mixed-replace; boundary=frame"
        )
        handler.end_headers()
        seen = -1
        try:
            while True:
                with self._cond:
                    if self._frame_no == seen:
                        self._cond.wait(timeout=5.0)
                    jpeg, seen = self._jpeg, self._frame_no
                if jpeg is None:
                    continue
                handler.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n")
                handler.wfile.write(
                    f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                )
                handler.wfile.write(jpeg)
                handler.wfile.write(b"\r\n")
        except (BrokenPipeError, ConnectionResetError):
            return

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._q.put(None)
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "LiveViewer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
