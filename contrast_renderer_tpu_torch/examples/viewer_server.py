"""Live browser viewer: orbit the showcase, rendered on the card.

The port's counterpart of examples/viewer_server.py, the in-browser
presentation surface of the reference (examples/showcase/index.html:7-11
canvas + module loader, server.js:15-38 dev server,
examples/showcase/main.rs:255-274 mouse orbit/zoom): a stdlib HTTP
server renders frames on demand through ``FrameProgram`` and streams
them to a <canvas>; the browser's pointer events drive the same
yaw/pitch/distance camera the reference accumulates from winit cursor
deltas.

The browser requests the next frame as soon as the previous one arrives
(natural backpressure: the device is never more than one frame ahead of
the viewer), sending the ABSOLUTE camera state each time so the server
stays stateless.  Frames render kernel-packed RGBA8 (the presentation
format) and are composited over the page background on the device, so
the canvas blit is a raw putImageData.

The server binds 127.0.0.1 unless given ``--host``.

Usage:
    python -m contrast_renderer_tpu_torch.examples.viewer_server \\
        [--size WxH] [--port 8080] [--host 127.0.0.1] [--no-text] \\
        [--device cuda|cpu]
then open http://localhost:8080/ (forward the port if remote).
"""

import argparse
import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from ..models import showcase
from ..renderer import Configuration, Renderer
from ..utils.matrix import _quat_mul, rotate_around_axis

#: The interface the server binds unless told otherwise: this host only.
DEFAULT_HOST = "127.0.0.1"

PAGE = """<!DOCTYPE html>
<html>
<head><meta charset="utf-8"><title>contrast_renderer_tpu_torch — showcase</title>
<style>
 body { margin: 0; background: #222; color: #ddd;
        font: 13px system-ui, sans-serif; }
 #bar { padding: 6px 10px; }
 canvas { display: block; margin: 0 auto; cursor: grab;
          touch-action: none; }
</style></head>
<body>
<div id="bar">drag to orbit &middot; wheel to zoom &middot;
 <span id="fps">...</span></div>
<canvas id="c" width="__W__" height="__H__"></canvas>
<script>
const W = __W__, H = __H__;
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
const img = ctx.createImageData(W, H);
let yaw = 0.0, pitch = 0.0, dist = 5.0, dragging = false, last = null;
canvas.addEventListener('pointerdown', e => {
  dragging = true; last = [e.clientX, e.clientY];
  canvas.setPointerCapture(e.pointerId);
});
canvas.addEventListener('pointerup', () => { dragging = false; });
canvas.addEventListener('pointermove', e => {
  if (!dragging || !last) { last = [e.clientX, e.clientY]; return; }
  yaw += (e.clientX - last[0]) * 0.005;     // main.rs:255-267
  pitch += (e.clientY - last[1]) * 0.005;
  last = [e.clientX, e.clientY];
});
canvas.addEventListener('wheel', e => {
  e.preventDefault();
  dist = Math.min(100, Math.max(1, dist * Math.exp(0.001 * e.deltaY)));
}, { passive: false });
let frames = 0, t0 = performance.now();
async function loop() {
  for (;;) {
    const t = performance.now() / 1000;
    const q = `yaw=${yaw}&pitch=${pitch}&dist=${dist}&t=${t}`;
    const resp = await fetch('/frame?' + q);
    if (!resp.ok) { await new Promise(r => setTimeout(r, 250)); continue; }
    const buf = new Uint8Array(await resp.arrayBuffer());
    img.data.set(buf);
    ctx.putImageData(img, 0, 0);
    if (++frames % 16 === 0) {
      const now = performance.now();
      document.getElementById('fps').textContent =
        (16000 / (now - t0)).toFixed(1) + ' fps (round-trip)';
      t0 = now;
    }
  }
}
loop();
</script></body></html>
"""


class ShowcaseSession:
    """One showcase FrameProgram + the camera math shared with
    ``orbit_camera`` (the reference's event-driven camera,
    main.rs:255-274)."""

    def __init__(self, width, height, with_text=True, scout_frames=16,
                 device="cuda"):
        self.width, self.height = width, height
        self.renderer = Renderer(
            Configuration(), width, height, strict_capacity=False,
            device=device,
        )
        self.shape = showcase.build_shape(with_text=with_text)
        commands = showcase.showcase_commands(self.shape, width, height)
        self.program = self.renderer.compile_frame(
            commands, uint8_output=True
        )
        # One fused grouping valid across a whole yaw orbit, so that
        # horizontal dragging dispatches the fused variant at once (other
        # motions derive their own grouping per frame, or walk in
        # sequence).  scout_frames yaw samples cover the circle; each
        # costs a binning, so CPU hosts (tests) pass fewer.
        if scout_frames:
            step = 2.0 * math.pi / scout_frames
            self.program.plan_for_motion(
                [
                    self._transforms(step * i, 0.0, 5.0)
                    for i in range(scout_frames)
                ]
            )
        self._lock = threading.Lock()

    def _transforms(self, yaw, pitch, dist):
        rotor = _quat_mul(
            rotate_around_axis(yaw, [0.0, 1.0, 0.0]),
            rotate_around_axis(pitch, [1.0, 0.0, 0.0]),
        )
        return showcase.command_transforms(
            self.width, self.height,
            view_rotation=rotor, view_distance=dist,
        )

    def frame(self, yaw, pitch, dist, t) -> bytes:
        """One frame as W·H·4 bytes of RGBA8, composited over white."""
        with self._lock:
            self.shape.set_dynamic_stroke_options(
                0, showcase.dashed_options(t * 2.0)
            )
            image = self.program(self._transforms(yaw, pitch, dist))
            # Premultiplied over white (int32, no wrap), full alpha for
            # the canvas blit.
            out = image.to(torch.int32)
            rgb = torch.clamp(out[..., :3] + (255 - out[..., 3:4]), max=255)
            out = torch.cat([rgb, torch.full_like(out[..., 3:4], 255)], -1)
            return out.to(torch.uint8).cpu().numpy().tobytes()


def make_handler(session):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet per-request spam
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                page = PAGE.replace("__W__", str(session.width)).replace(
                    "__H__", str(session.height)
                )
                self._send(200, page.encode(), "text/html; charset=utf-8")
                return
            if url.path == "/frame":
                q = parse_qs(url.query)

                def f(name, default):
                    try:
                        v = float(q.get(name, [default])[0])
                    except ValueError:
                        return default
                    return v if math.isfinite(v) else default

                try:
                    body = session.frame(
                        f("yaw", 0.0), f("pitch", 0.0),
                        min(100.0, max(1.0, f("dist", 5.0))),
                        f("t", 0.0),
                    )
                except Exception:
                    # The server keeps serving; the failure is logged
                    # with its traceback and answered with a 500.
                    logging.getLogger("viewer").exception("render failed")
                    self._send(500, b"render failed", "text/plain")
                    return
                self._send(200, body, "application/octet-stream")
                return
            if url.path == "/meta":
                body = json.dumps(
                    {"width": session.width, "height": session.height}
                ).encode()
                self._send(200, body, "application/json")
                return
            self._send(404, b"not found", "text/plain")

    return Handler


def make_server(session, port=8080, host=DEFAULT_HOST):
    """A ThreadingHTTPServer for ``session`` on ``host:port`` (port 0
    picks a free one; ``server.server_address`` says which)."""
    return ThreadingHTTPServer((host, port), make_handler(session))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", default="960x540")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--host", default=DEFAULT_HOST,
                        help="interface to bind (default: this host only)")
    parser.add_argument("--no-text", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (cuda or cpu)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("viewer")

    width, height = (int(x) for x in args.size.split("x"))
    t0 = time.perf_counter()
    session = ShowcaseSession(
        width, height, with_text=not args.no_text, device=args.device
    )
    # Warm the dispatch path so the first browser frame is instant.
    session.frame(0.0, 0.0, 5.0, 0.0)
    log.info(
        "showcase ready in %.1fs at %dx%d", time.perf_counter() - t0,
        width, height,
    )
    server = make_server(session, args.port, args.host)
    log.info("open http://localhost:%d/ (forward the port if remote)",
             server.server_address[1])
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
