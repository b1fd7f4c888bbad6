"""Port parity: the orbit rig (`utils.orbit`) and the interactive viewer
(`viewer/`), on the CPU at 16x16.

  * `OrbitCamera` gives the JAX rig's positions, targets and cameras
    through rotate, zoom and pan;
  * `PARAM_SPEC` and the page are JAX's;
  * the session and server tests of tests/test_viewer.py: the progressive
    loop, parameter and camera changes resetting it, scene and env
    switches, the control actions, and every route (`/`, `/spec`,
    `/state`, `/frame.png`, `/params`, `/camera`, `/control`,
    `/upload/scene` with a Draco GLB, `/upload/env`).

Every wait has a limit (`_wait`, the HTTP timeouts), and every session
and server is stopped in a `finally` or a fixture's teardown: `stop()`
joins the render loop within its own limit and raises if it outlives it.
"""

import json
import math
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_pathtracer.utils.orbit import OrbitCamera as JOrbit
from tpu_pathtracer.viewer import page as jpage
from tpu_pathtracer.viewer import session as jsession
from tpu_pathtracer_torch.config import PostConfig, RenderConfig
from tpu_pathtracer_torch.io.gltf import save_glb
from tpu_pathtracer_torch.io.hdr import write_hdr
from tpu_pathtracer_torch.scene import primitives
from tpu_pathtracer_torch.scene.host import Material, Mesh
from tpu_pathtracer_torch.utils.orbit import OrbitCamera
from tpu_pathtracer_torch.viewer import ViewerServer, ViewerSession, page
from tpu_pathtracer_torch.viewer.session import PARAM_SPEC

WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tests' many small ops: under the
    suite's parallel workers, torch's default pool (a thread a core in
    each worker) oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _orbit_pair(**kw):
    return OrbitCamera(**kw), JOrbit(**kw)


def _assert_same_rig(a, b):
    assert vars(a) == vars(b)
    np.testing.assert_array_equal(a.position, b.position)
    ca, cb = a.camera(), b.camera()
    for field in ("position", "direction", "fov", "focal_distance", "aperture"):
        np.testing.assert_array_equal(getattr(ca, field).numpy(), np.asarray(getattr(cb, field)))


@pytest.mark.parametrize("op", ["none", "rotate", "rotate_clamped", "zoom", "zoom_floor", "pan",
                                "all"])
def test_orbit_camera_matches_jax(op):
    kw = dict(target=(0.25, 0.5, -0.5), radius=3.5, azimuth=0.3, elevation=0.4, fov=50.0,
              focal_distance=2.0, aperture=0.05)
    a, b = _orbit_pair(**kw)
    steps = {"none": [], "rotate": [("rotate", 1.2, -0.3)],
             "rotate_clamped": [("rotate", 2 * math.pi + 0.1, 10.0)],
             "zoom": [("zoom", 1.3)], "zoom_floor": [("zoom", 1e-9)],
             "pan": [("pan", 0.5, -0.25)],
             "all": [("rotate", 0.7, 0.2), ("zoom", 0.8), ("pan", -0.3, 0.1), ("rotate", -2, 1)]}
    for name, *args in steps[op]:
        a, b = getattr(a, name)(*args), getattr(b, name)(*args)
    _assert_same_rig(a, b)


def test_orbit_camera_on_a_device():
    cam = OrbitCamera().camera("cpu")
    assert cam.position.device.type == "cpu" and cam.position.dtype.is_floating_point


def test_param_spec_and_page_are_jax_s():
    assert PARAM_SPEC == jsession.PARAM_SPEC
    assert page.PAGE_HTML == jpage.PAGE_HTML


def _tiny_session(frames=4):
    cfg = RenderConfig(width=16, height=16, scaling_factor=1.0, frames=frames,
                       samples_per_frame=1, max_bounces=2)
    return ViewerSession(config=cfg, post=PostConfig(denoise=False), device="cpu")


def _wait(pred, timeout=WAIT_S):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


class TestSession:
    def test_progressive_loop_completes(self):
        s = _tiny_session(frames=3)
        events = []
        s.renderer.on("complete", lambda *a: events.append("complete"))
        s.start()
        try:
            assert _wait(lambda: s.renderer.status == "idle")
            assert events == ["complete"]
            assert s.renderer.frame == 4  # 1-based counter past the budget
            v, png = s.frame_png()
            assert png[:8] == b"\x89PNG\r\n\x1a\n"
            assert v == s.version and s.state()["fps"] > 0
        finally:
            s.stop()
        assert s._thread is None

    def test_param_update_resets(self):
        s = _tiny_session(frames=64)
        s.start()
        try:
            assert _wait(lambda: s.renderer.frame >= 3)
            s.apply_params({"bounces": 1})
            st = s.state()
            assert st["params"]["bounces"] == 1
            assert st["frame"] <= 2  # reset happened
            s.apply_params({"tonemap": "reinhard", "denoise": True, "env_intensity": 2.0,
                            "env_rotation": 30.0, "fov": 60.0, "timing": True})
            p = s.state()["params"]
            assert p["tonemap"] == "reinhard" and p["denoise"] is True
            assert p["env_intensity"] == 2.0 and p["env_rotation"] == 30.0
            assert p["fov"] == 60.0 and p["timing"] is True
            assert set(p) == {spec["name"] for spec in PARAM_SPEC}
        finally:
            s.stop()

    def test_camera_orbit_changes_image(self):
        s = _tiny_session(frames=2)
        s.start()
        try:
            assert _wait(lambda: s.renderer.status == "idle")
            _, png_a = s.frame_png()
            s.apply_camera({"rotate": [1.2, 0.1], "zoom": 1.3, "pan": [0.1, 0.0]})
            assert s.renderer.camera.position.device.type == "cpu"
            assert _wait(lambda: s.renderer.status == "idle")
            _, png_b = s.frame_png()
            assert png_a != png_b
        finally:
            s.stop()

    def test_scene_and_env_switch(self):
        s = _tiny_session(frames=2)
        s.set_scene("torus-knot")
        assert s.state()["scene_stats"]["triangles"] > 1000
        s.set_env("black")
        assert s.state()["params"]["env"] == "black"
        s.set_env("sky:elevation=10,turbidity=5")
        assert s.renderer.scene.env_radiance.shape == (512, 1024, 3)
        with pytest.raises(ValueError):
            s.set_scene("nope")
        with pytest.raises(ValueError):
            s.set_env("nope")

    def test_control_actions(self):
        s = _tiny_session()
        s.control("start")
        assert s.renderer.status == "sampling"
        s.control("pause")
        assert s.renderer.status == "paused"
        s.control("reset")
        assert s.renderer.frame == 1
        with pytest.raises(ValueError):
            s.control("explode")

    def test_requests_take_turns_with_the_loop(self):
        """More request threads than cores against the running loop, with a
        short switch interval: every request finishes in time, and the
        count of queued callers (which holds the loop back) returns to 0."""
        import sys
        import threading

        s = _tiny_session(frames=2048)
        done = []

        def requests():
            for k in range(3):
                s.apply_camera({"zoom": 1.0}) if k % 2 else s.frame_png()
            done.append(1)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        s.start()
        try:
            threads = [threading.Thread(target=requests)
                       for _ in range(min(64, 2 * (os.cpu_count() or 1)))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads) and len(done) == len(threads)
            assert s._queued == 0
            assert _wait(lambda: s.renderer.frame >= 2)  # the loop still renders
        finally:
            sys.setswitchinterval(interval)
            s.stop()

    def test_a_failed_loop_is_raised_by_stop(self, monkeypatch):
        s = _tiny_session()

        def broken():
            raise RuntimeError("frame failed")

        monkeypatch.setattr(s.renderer, "render", broken)
        s.start()
        try:
            assert _wait(lambda: s._thread is not None and not s._thread.is_alive())
            with pytest.raises(RuntimeError, match="frame failed"):
                s.state()
        finally:
            with pytest.raises(RuntimeError, match="render loop failed"):
                s.stop()


@pytest.fixture(scope="module")
def server():
    srv = ViewerServer(session=_tiny_session(frames=4), port=0)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()
    assert srv.session._thread is None


def _get(srv, path):
    with urllib.request.urlopen(srv.url.rstrip("/") + path, timeout=30) as r:
        return r.status, r.read(), dict(r.headers)


def _post(srv, path, body: bytes):
    req = urllib.request.Request(srv.url.rstrip("/") + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


class TestServer:
    def test_page(self, server):
        status, body, headers = _get(server, "/")
        assert status == 200 and b"tpu-pathtracer" in body
        assert "text/html" in headers["Content-Type"]

    def test_spec_and_state(self, server):
        _, body, _ = _get(server, "/spec")
        assert json.loads(body) == PARAM_SPEC
        _, body, _ = _get(server, "/state")
        st = json.loads(body)
        assert st["status"] in ("sampling", "paused", "idle")
        assert set(st["params"]) == {s["name"] for s in PARAM_SPEC}
        assert st["resolution"]["width"] == 16

    def test_frame_png(self, server):
        assert _wait(lambda: server.session.version > 0)
        status, body, headers = _get(server, "/frame.png")
        assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        assert int(headers["X-Frame-Version"]) >= 1

    def test_post_params_and_camera(self, server):
        status, out = _post(server, "/params", b'{"fov": 60}')
        assert status == 200 and out["params"]["fov"] == 60
        status, out = _post(server, "/camera", b'{"zoom": 1.1}')
        assert status == 200 and out["ok"]
        _post(server, "/params", b'{"frames": 2048}')
        _post(server, "/control", b'{"action": "reset"}')
        status, out = _post(server, "/control", b'{"action": "pause"}')
        assert out["status"] == "paused"
        _post(server, "/params", b'{"frames": 4}')
        _post(server, "/control", b'{"action": "start"}')

    def test_bad_requests(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/params", b'{"tonemap": "bogus"}')
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server, "/nope")
        assert e.value.code == 404

    def test_upload_env_hdr(self, server, tmp_path):
        env = np.random.default_rng(0).uniform(0, 2, (16, 32, 3)).astype(np.float32)
        path = tmp_path / "env.hdr"
        write_hdr(str(path), env)
        status, out = _post(server, "/upload/env", path.read_bytes())
        assert status == 200 and out["ok"]
        assert server.session.params()["env"] == "imported"

    def test_upload_draco_scene_glb(self, server, tmp_path):
        p, n, idx = primitives.sphere(0.5, 8, 8)
        path = tmp_path / "s.glb"
        save_glb([Mesh(p, n, idx, Material(color=(1, 1, 1)))], str(path), draco=True)
        status, out = _post(server, "/upload/scene", path.read_bytes())
        assert status == 200
        assert out["scene_stats"]["triangles"] == len(np.asarray(idx).reshape(-1, 3))
        v0 = server.session.version
        assert _wait(lambda: server.session.version >= v0 + 2)
        status, body, _ = _get(server, "/frame.png")
        assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
