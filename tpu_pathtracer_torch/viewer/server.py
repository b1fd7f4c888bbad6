"""Dependency-free HTTP server for the interactive viewer (the port of
`tpu_pathtracer.viewer.server`).

Endpoints (all JSON unless noted):

  GET  /              the viewer page (page.py)
  GET  /spec          PARAM_SPEC — the page builds its panel from this
  GET  /state         status / frame / progress / fps / timings / params
  GET  /frame.png     current display image (PNG); ETag = image version
  POST /params        partial PARAMS update  {"frames": 128, ...}
  POST /camera        orbit op {"rotate":[da,de]} | {"zoom":f} | {"pan":[dx,dy]}
  POST /control       {"action": "start"|"pause"|"reset"}
  POST /upload/scene  raw .glb body → replace scene (normalized)
  POST /upload/env    raw .hdr body → replace environment

The server binds 127.0.0.1 by default: the render loop runs next to the
card; the page is just a remote control.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .page import PAGE_HTML
from .session import PARAM_SPEC, ViewerSession


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    session: ViewerSession  # set by ViewerServer

    # -- helpers ---------------------------------------------------------

    def _send(self, code: int, body: bytes, ctype: str,
              extra: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def log_message(self, fmt, *args):  # quiet
        pass

    # -- routes ----------------------------------------------------------

    def do_GET(self) -> None:
        path = self.path.split("?", 1)[0]
        try:
            if path == "/":
                self._send(200, PAGE_HTML.encode(), "text/html; charset=utf-8")
            elif path == "/spec":
                self._json(PARAM_SPEC)
            elif path == "/state":
                self._json(self.session.state())
            elif path == "/frame.png":
                version, png = self.session.frame_png()
                self._send(200, png, "image/png",
                           {"X-Frame-Version": str(version)})
            else:
                self._json({"error": "not found"}, 404)
        except Exception as e:  # surface errors to the page
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    def do_POST(self) -> None:
        path = self.path.split("?", 1)[0]
        try:
            if path == "/params":
                self.session.apply_params(json.loads(self._body() or b"{}"))
                self._json({"ok": True, "params": self.session.params()})
            elif path == "/camera":
                self.session.apply_camera(json.loads(self._body() or b"{}"))
                self._json({"ok": True})
            elif path == "/control":
                action = json.loads(self._body() or b"{}").get("action", "")
                self.session.control(action)
                self._json({"ok": True, "status": self.session.renderer.status})
            elif path == "/upload/scene":
                self.session.load_scene_glb(self._body())
                self._json({"ok": True,
                            "scene_stats": self.session.state()["scene_stats"]})
            elif path == "/upload/env":
                self.session.load_env_hdr(self._body())
                self._json({"ok": True})
            else:
                self._json({"error": "not found"}, 404)
        except Exception as e:
            self._json({"error": f"{type(e).__name__}: {e}"}, 400)


class ViewerServer:
    """Owns a ViewerSession + ThreadingHTTPServer; start()/stop()."""

    def __init__(self, session: Optional[ViewerSession] = None,
                 host: str = "127.0.0.1", port: int = 8790) -> None:
        self.session = session or ViewerSession()
        handler = type("BoundHandler", (_Handler,), {"session": self.session})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}/"

    def start(self) -> None:
        self.session.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="viewer-http")
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.session.stop()


def serve(host: str = "127.0.0.1", port: int = 8790,
          session: Optional[ViewerSession] = None,
          block: bool = True) -> ViewerServer:
    server = ViewerServer(session=session, host=host, port=port)
    server.start()
    print(f"viewer: {server.url}  (ctrl-c to stop)", flush=True)
    if block:
        try:
            while True:
                threading.Event().wait(3600)
        except KeyboardInterrupt:
            pass
        finally:
            server.stop()
    return server
