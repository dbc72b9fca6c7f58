"""The port's viewer (gltf_renderer_tpu_torch/app/viewer.py).

- Input handling against the JAX package's app/viewer.py: the same event
  lists through `_apply_inputs` (and so `_apply_setting`) leave both
  renderers' settings and params equal, the Graphics-tab snapshots
  (`_settings_dict`) equal, and the controllers, camera matrix (bit for
  bit), camera mode, animation player, selected scene and tracked camera
  equal. Groups: every `set` field (bounce counts past MAX_BOUNCES_HARD_CAP
  and min above max clamped), orbit / dolly / pan, fly mode with keys and
  look, the backend toggle, animation select and transport, and scene and
  glTF camera select. No frame is drawn.
- One HTTP round trip: `serve(block=False, port=0, device="cpu")` on the
  box at 32x24 bound to the loopback: GET /, /state and /frame.png with
  X-Frame-Seq; POST inputs and wait, under a deadline, until /state shows
  every field asserted and a newer frame is published; then shut down.
- A frame that raises stops the render loop and shows in /state.
"""

import dataclasses
import json
import time
import urllib.request

import numpy as np
import pytest
from PIL import Image

from gltf_renderer_tpu.app import viewer as jviewer
from gltf_renderer_tpu.camera import OrbitController as JOrbit
from gltf_renderer_tpu.render import settings as JS
from gltf_renderer_tpu.render.renderer import Renderer as JRenderer
from gltf_renderer_tpu_torch.app import viewer as pviewer
from gltf_renderer_tpu_torch.camera import OrbitController as POrbit
from gltf_renderer_tpu_torch.render import settings as PS
from gltf_renderer_tpu_torch.render.renderer import Renderer as PRenderer
from tests.scenes import write_box_gltf, write_camera_anim_gltf

DEADLINE_S = 60


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("viewer")
    return {"box": write_box_gltf(str(d / "box.gltf")),
            "camera_anim": write_camera_anim_gltf(str(d / "cam.gltf"))}


def _set(field, value):
    return {"type": "set", "field": field, "value": value}


EVENTS = {
    "set_every_field": (
        [_set(f, i % 2 == 0) for i, f in enumerate(jviewer._PT_BOOLS)]
        + [_set("max_bounces", 9), _set("min_bounces", -3), _set("min_bounces", 4),
           _set("max_bounces", 2), _set("debug_output", 11), _set("max_accumulated_frames", 64)]
        + [_set(f, 0.25 + i) for i, f in enumerate(jviewer._PARAM_FIELDS)]
        + [_set("fixed_seed", 7.9), _set("tonemapper", "agx"), _set("tonemapper", 0),
           _set("exposure", 2.5), _set("bloom_enabled", False), _set("bloom_strength", 0.2),
           _set("backend", "rasterizer"), _set("no_such_field", 1)]),
    "orbit_dolly_pan": [
        {"type": "orbit", "dx": 80, "dy": -30}, {"type": "orbit", "dx": 0, "dy": 900},
        {"type": "dolly", "amount": -120}, {"type": "dolly", "amount": 5000},
        {"type": "pan", "dx": 15, "dy": -7}, {"type": "key", "keys": ["w"], "dt": 0.5}],
    "fly_mode": [
        {"type": "orbit", "dx": 40, "dy": 10}, {"type": "mode", "value": "free"},
        {"type": "key", "keys": ["w", "d"], "shift": True, "dt": 0.25},
        {"type": "key", "keys": ["s", "a"], "dt": 0.5}, {"type": "key", "keys": ["q", "E"]},
        {"type": "orbit", "dx": 40, "dy": -10}, {"type": "dolly", "amount": -120},
        {"type": "pan", "dx": 3, "dy": 4}, {"type": "mode", "value": "orbit"},
        {"type": "mode", "value": "sideways"}],
    "backend": [{"type": "backend"}, {"type": "backend"}, {"type": "backend"}],
    "animation": [
        {"type": "animation", "index": 0}, {"type": "anim", "playing": False},
        {"type": "anim", "looping": False}, {"type": "anim", "time": 1.25},
        {"type": "animation", "index": 5}, {"type": "animation", "index": None},
        {"type": "anim", "time": 0.5, "playing": True}],
    "scene_and_camera": [
        {"type": "scene", "index": 0}, {"type": "scene", "index": 3},
        {"type": "camera", "index": 0}, {"type": "camera", "index": 7},
        {"type": "camera", "index": None}, {"type": "unknown"}],
}


def _state(pkg, path):
    R, S, Orbit, V = ((JRenderer, JS, JOrbit, jviewer) if pkg == "jax"
                      else (lambda s: PRenderer(s, device="cpu"), PS, POrbit, pviewer))
    r = R(S.RenderSettings(width=64, height=32))
    r.load_scene(path)
    orbit = Orbit(centre=np.zeros(3, np.float32), radius=4.0)
    r.camera.world_to_view = orbit.world_to_view()
    return V.ViewerState(r, orbit, 64, 32)


def _snapshot(pkg, st):
    V = jviewer if pkg == "jax" else pviewer
    r = st.renderer
    p = r.player
    return dict(
        settings=dataclasses.asdict(r.settings), params=tuple(r.params),
        graphics=V._settings_dict(r), cam_mode=st.cam_mode,
        orbit=(np.asarray(st.orbit.centre).tobytes(), st.orbit.radius, st.orbit.azimuth,
               st.orbit.inclination),
        free=(np.asarray(st.free.position).tobytes(), st.free.azimuth, st.free.inclination,
              st.free.speed),
        view=np.asarray(r.camera.world_to_view).tobytes(),
        player=(p.animation is None, p.time, p.playing, p.looping),
        scene=(r.scene_id, r._track_camera, r._track_camera_node, r.camera.y_fov,
               r.camera.aspect_ratio))


@pytest.mark.parametrize("group", list(EVENTS))
def test_inputs_match_jax(group, files):
    path = files["camera_anim"]
    states = {pkg: _state(pkg, path) for pkg in ("jax", "port")}
    for ev in EVENTS[group]:
        moved = {}
        for pkg, st in states.items():
            V = jviewer if pkg == "jax" else pviewer
            moved[pkg] = V._apply_inputs(st, [dict(ev)])
        assert moved["jax"] == moved["port"], ev
        a, b = (_snapshot(pkg, st) for pkg, st in states.items())
        for k in a:
            assert a[k] == b[k], (ev, k, a[k], b[k])
    s = states["port"].renderer.settings.pt
    assert 0 <= s.min_bounces <= s.max_bounces <= 5


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=10)


def _post(base, payload):
    req = urllib.request.Request(base + "/input", data=json.dumps(payload).encode(),
                                 method="POST")
    assert urllib.request.urlopen(req, timeout=10).read() == b"ok"


def _wait(pred, what):
    deadline = time.time() + DEADLINE_S
    while time.time() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _serve(path, **kw):
    return pviewer.serve(path, width=32, height=24, port=0, block=False, device="cpu",
                         host="127.0.0.1", **kw)


def _stop(server, state, thread):
    state.running = False
    server.shutdown()
    server.server_close()
    thread.join(timeout=DEADLINE_S)
    assert not thread.is_alive()


def test_http_round_trip(files):
    server, state, thread = _serve(files["box"])
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        _wait(lambda: state.frame_seq > 0, "the first frame")
        page = _get(base, "/").read()
        assert b"pointerdown" in page and b"Debug Output" in page
        r = _get(base, "/frame.png")
        seq0 = int(r.headers["X-Frame-Seq"])
        assert r.read()[:8] == b"\x89PNG\r\n\x1a\n" and seq0 >= 1
        st = json.loads(_get(base, "/state").read())
        assert st["backend"] == "pathtracer" and st["settings"]["debug_output"] == 0
        assert st["error"] is None and st["running"] is True
        assert st["stats"]["scene_bytes"] > 0 and st["history"]

        _post(base, _set("debug_output", 11))
        _post(base, _set("max_bounces", 9))
        _post(base, {"type": "orbit", "dx": 80, "dy": 0})

        def landed():  # every field asserted below: the inputs may land in any frames
            s = json.loads(_get(base, "/state").read())
            ok = (s["settings"]["debug_output"] == 11 and s["settings"]["max_bounces"] == 5
                  and s["frame"] > seq0 and state.orbit.azimuth != 0.0)
            return s if ok else None

        s = _wait(landed, "/state to show the inputs and a newer frame")
        assert s["settings"]["debug_output"] == 11 and s["settings"]["max_bounces"] == 5
        assert state.orbit.azimuth == pytest.approx(0.4)
        r = _get(base, "/frame.png")
        assert int(r.headers["X-Frame-Seq"]) > seq0
        assert np.asarray(Image.open(r)).shape == (24, 32, 3)
    finally:
        _stop(server, state, thread)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_failed_frame_stops_the_loop(files, monkeypatch):
    server, state, thread = _serve(files["box"])
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        _wait(lambda: state.frame_seq > 0, "the first frame")

        def fail(*a, **kw):
            raise RuntimeError("frame failed")

        monkeypatch.setattr(state.renderer, "draw_frame", fail)
        _post(base, {"type": "orbit", "dx": 10, "dy": 0})
        s = _wait(lambda: (lambda s: s if s["error"] else None)(
            json.loads(_get(base, "/state").read())), "the error in /state")
        assert s["error"] == "RuntimeError: frame failed" and s["running"] is False
        thread.join(timeout=DEADLINE_S)
        assert not thread.is_alive()
    finally:
        _stop(server, state, thread)
