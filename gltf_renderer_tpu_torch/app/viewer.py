"""Interactive live viewer (port of gltf_renderer_tpu/app/viewer.py) — the
app-shell analogue of the reference's SDL3 + ImGui window (Main.cpp:159-406)
for display-less GPU hosts: the browser is the window.

  python -m gltf_renderer_tpu_torch.app.viewer scene.glb [--port 8008] [...]

A render thread runs the same Renderer event loop the reference drives per
frame (camera input -> reset accumulation -> progressive PT / raster draw),
and a stdlib HTTP server blits frames and feeds input back:

  GET  /            small HTML page (canvas + drag/wheel handlers + panel)
  GET  /frame.png   latest rendered frame (+ X-Frame-Seq header)
  GET  /state       JSON {frame, spp, backend, scene, settings, animations..}
  POST /input       JSON {type: "orbit"|"dolly"|"pan"|"key"|"backend"|
                          "load"|"set"|"animation"|"anim"|"camera", ...} —
                          mouse orbit/dolly (the reference's
                          CameraController), backend toggle, the full
                          Graphics-tab control set ("set" covers every
                          path-tracer flag/slider incl. the 28 debug
                          outputs, tonemap, bloom), animation
                          play/pause/loop/time transport, glTF camera
                          select, load-by-path (its drag-drop).

Parity map: window/event loop = Main.cpp:159-226; orbit/dolly input =
CameraController.h:9-243; Graphics tab controls = Main.cpp:224-340 (debug
output :288-300, Use Frame As Seed :302-305, bounces/RR :307-320, env
:322-330, luminance clamp :331-333, tonemap/exposure :226-247); glTF tab
animation transport = Main.cpp:196-222; drag-drop load = Main.cpp:238-254.

The render thread owns the Renderer (on the CUDA card unless `serve` is
given another device); the HTTP threads read the published PNG and queue
inputs. A frame that raises stops the loop, and /state reports the error.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>gltf-renderer-tpu-torch</title><style>
 body { margin:0; background:#111; color:#ccc; font:13px monospace; }
 #hud { position:fixed; top:8px; left:8px; background:#0008; padding:6px; }
 #panel { position:fixed; top:8px; right:8px; background:#000b; padding:6px;
          max-height:95vh; overflow-y:auto; width:280px; }
 #panel label { display:flex; justify-content:space-between; margin:2px 0; }
 #panel input[type=number] { width:70px; }
 img { display:block; margin:auto; image-rendering:pixelated; }
</style></head><body>
<div id="hud">drag: orbit/look &middot; wheel: dolly/speed &middot; shift-drag: pan &middot; fly: WASD+QE
 &middot; <span id="stat"></span></div>
<details id="panel"><summary>Graphics</summary>
<div><label>Renderer <select id="backend">
  <option value="pathtracer">Path Tracer</option>
  <option value="rasterizer">Rasterizer</option></select></label>
<label>Debug Output <select id="debug_output"></select></label>
<label>Tonemapper <select id="tonemapper">
  <option value="0">None</option><option value="1">AgX</option></select></label>
<label>Exposure <input type="number" id="exposure" step="0.1"></label>
<label>Min Bounces <input type="number" id="min_bounces" min="0" max="5"></label>
<label>Max Bounces <input type="number" id="max_bounces" min="0" max="5"></label>
<label>Min RR Prob <input type="number" id="min_russian_roulette_continue_prob" step="0.05"></label>
<label>Max RR Prob <input type="number" id="max_russian_roulette_continue_prob" step="0.05"></label>
<label>Env Intensity <input type="number" id="environment_intensity" step="0.1"></label>
<label>Luminance Clamp <input type="number" id="luminance_clamp" step="1"></label>
<label>Seed <input type="number" id="fixed_seed" step="1"></label>
<div id="checks"></div>
<hr><label>Scene <select id="scenesel"></select></label>
<label>Animation <select id="animsel"><option value="">None</option></select></label>
<label>Play <input type="checkbox" id="anim_play" checked></label>
<label>Loop <input type="checkbox" id="anim_loop" checked></label>
<label>Time <input type="range" id="anim_time" min="0" max="10" step="0.05"
  style="width:140px"></label>
<label>Camera <select id="camsel"><option value="">Free orbit</option></select></label>
<label>Controller <select id="ctlsel">
  <option value="orbit">Orbit</option>
  <option value="free">Fly (WASD+QE)</option></select></label>
</div></details>
<img id="v" draggable="false">
<script>
const DEBUG_NAMES = ['None','Hit Kind','Vertex Color','Vertex Alpha',
 'Vertex Normal','Vertex Tangent','Vertex Bitangent','Texcoord 0','Texcoord 1',
 'Color','Alpha','Shading Normal','Shading Tangent','Shading Bitangent',
 'Metalness','Roughness','Specular','Specular Color','Clearcoat',
 'Clearcoat Roughness','Clearcoat Normal','Transmissive','Bounce Direction',
 'Bounce BSDF','Bounce PDF','Bounce Weight','Bounce Is Transmission',
 'Hemisphere View Side'];
const BOOLS = ['accumulate','luminance_clamp_enabled',
 'indirect_environment_only','point_lights','shadow_rays','alpha_shadows',
 'environment_map','environment_mis','material_diffuse_white',
 'material_use_geometric_normals','material_mis','show_nan','show_inf',
 'shading_normal_adaptation','cull_backface','use_frame_as_seed'];
const NUMS = ['exposure','min_bounces','max_bounces',
 'min_russian_roulette_continue_prob','max_russian_roulette_continue_prob',
 'environment_intensity','luminance_clamp','fixed_seed'];
function send(field, value) {
  fetch('/input', {method:'POST', body: JSON.stringify(
    {type:'set', field: field, value: value})});
}
const dbg = document.getElementById('debug_output');
DEBUG_NAMES.forEach((n, i) => {
  const o = document.createElement('option'); o.value = i; o.textContent = n;
  dbg.appendChild(o);
});
dbg.onchange = () => send('debug_output', parseInt(dbg.value));
const checks = document.getElementById('checks');
BOOLS.forEach(f => {
  const l = document.createElement('label');
  l.innerHTML = f.replaceAll('_',' ') + ' <input type="checkbox" id="' + f + '">';
  checks.appendChild(l);
  l.querySelector('input').onchange = e => send(f, e.target.checked);
});
NUMS.forEach(f => {
  const el = document.getElementById(f);
  if (el) el.onchange = () => send(f, parseFloat(el.value));
});
document.getElementById('tonemapper').onchange =
  e => send('tonemapper', parseInt(e.target.value));
document.getElementById('backend').onchange =
  e => send('backend', e.target.value);
document.getElementById('scenesel').onchange = e => fetch('/input',
  {method:'POST', body: JSON.stringify({type:'scene',
   index: parseInt(e.target.value)})});
document.getElementById('animsel').onchange = e => fetch('/input',
  {method:'POST', body: JSON.stringify({type:'animation',
   index: e.target.value === '' ? null : parseInt(e.target.value)})});
document.getElementById('anim_play').onchange = e => fetch('/input',
  {method:'POST', body: JSON.stringify({type:'anim', playing: e.target.checked})});
document.getElementById('anim_loop').onchange = e => fetch('/input',
  {method:'POST', body: JSON.stringify({type:'anim', looping: e.target.checked})});
document.getElementById('anim_time').oninput = e => fetch('/input',
  {method:'POST', body: JSON.stringify({type:'anim', time: parseFloat(e.target.value),
   playing: false})});
document.getElementById('camsel').onchange = e => fetch('/input',
  {method:'POST', body: JSON.stringify({type:'camera',
   index: e.target.value === '' ? null : parseInt(e.target.value)})});
let camMode = 'orbit';
document.getElementById('ctlsel').onchange = e => {
  camMode = e.target.value;
  fetch('/input', {method:'POST', body: JSON.stringify(
    {type:'mode', value: camMode})});
};
// Fly-cam movement: keydown auto-repeat drives WASD+QE ticks, shift boosts
// (reference Tick, CameraController.h:202-227).
const held = new Set();
window.addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if (!'wasdqe'.includes(k) || camMode !== 'free') return;
  held.add(k);
  fetch('/input', {method:'POST', body: JSON.stringify(
    {type:'key', keys: Array.from(held), shift: e.shiftKey, dt: 0.05})});
});
window.addEventListener('keyup', e => { held.delete(e.key.toLowerCase()); });
let uiInit = false;
function syncUi(s) {
  if (uiInit) return;
  uiInit = true;
  BOOLS.forEach(f => { const el = document.getElementById(f);
    if (el) el.checked = !!s.settings[f]; });
  NUMS.forEach(f => { const el = document.getElementById(f);
    if (el) el.value = s.settings[f]; });
  dbg.value = s.settings.debug_output;
  document.getElementById('tonemapper').value = s.settings.tonemapper;
  document.getElementById('backend').value = s.backend;
  const ssel = document.getElementById('scenesel');
  for (let i = 0; i < s.scenes; i++) {
    const o = document.createElement('option'); o.value = i;
    o.textContent = 'Scene ' + i; ssel.appendChild(o);
  }
  ssel.value = s.scene_id;
  const asel = document.getElementById('animsel');
  for (let i = 0; i < s.animations; i++) {
    const o = document.createElement('option'); o.value = i;
    o.textContent = 'Animation ' + i; asel.appendChild(o);
  }
  const csel = document.getElementById('camsel');
  for (let i = 0; i < s.cameras; i++) {
    const o = document.createElement('option'); o.value = i;
    o.textContent = 'Camera ' + i; csel.appendChild(o);
  }
}
const img = document.getElementById('v');
const stat = document.getElementById('stat');
let seq = 0, busy = false;
async function tick() {
  if (!busy) {
    busy = true;
    try {
      const r = await fetch('/frame.png?seq=' + seq);
      seq = r.headers.get('X-Frame-Seq') || seq;
      const b = await r.blob();
      img.src = URL.createObjectURL(b);
      const s = await (await fetch('/state')).json();
      syncUi(s);   // one-shot UI init (combos + current settings)
      stat.textContent = s.backend + ' spp=' + s.spp;
    } catch (e) {}
    busy = false;
  }
  setTimeout(tick, 60);
}
tick();
let drag = null;
img.addEventListener('pointerdown', e => { drag = [e.clientX, e.clientY, e.shiftKey]; });
window.addEventListener('pointerup', () => { drag = null; });
window.addEventListener('pointermove', e => {
  if (!drag) return;
  const [x0, y0, pan] = drag;
  drag = [e.clientX, e.clientY, pan];
  fetch('/input', {method:'POST', body: JSON.stringify(
    {type: pan ? 'pan' : 'orbit', dx: e.clientX - x0, dy: e.clientY - y0})});
});
img.addEventListener('wheel', e => {
  e.preventDefault();
  fetch('/input', {method:'POST', body: JSON.stringify(
    {type:'dolly', amount: e.deltaY})});
}, {passive: false});
// Drag-drop of .gltf/.glb/.exr/.hdr (Main.cpp:367-406 SDL drop events).
window.addEventListener('dragover', e => { e.preventDefault(); });
window.addEventListener('drop', e => {
  e.preventDefault();
  const f = e.dataTransfer && e.dataTransfer.files && e.dataTransfer.files[0];
  if (!f) return;
  fetch('/upload?name=' + encodeURIComponent(f.name),
        {method:'POST', body: f});
});
</script></body></html>"""


class ViewerState:
    """Shared state between the HTTP threads and the render thread."""

    def __init__(self, renderer, orbit, width, height):
        from gltf_renderer_tpu_torch.camera import FreeController

        self.renderer = renderer
        self.orbit = orbit
        self.free = FreeController()     # WASD+QE fly-cam (reference
        self.cam_mode = "orbit"          # CameraController.h:124-243)
        self.width = width
        self.height = height
        self.lock = threading.Lock()
        self.pending = []          # input events (applied on the render thread)
        self.frame_png = b""
        self.frame_seq = 0
        self.spp = 0
        self.running = True
        self.scene_path = ""
        self.error = None          # the exception that stopped the render loop

    def post_input(self, ev):
        with self.lock:
            self.pending.append(ev)

    def take_inputs(self):
        with self.lock:
            evs, self.pending = self.pending, []
        return evs

    def publish(self, png, spp):
        with self.lock:
            self.frame_png = png
            self.frame_seq += 1
            self.spp = spp


# Graphics-tab field registry (Main.cpp:224-340). A change to any of them
# resets accumulation through the Renderer's reset key.
_PT_BOOLS = (
    "accumulate", "luminance_clamp_enabled", "indirect_environment_only",
    "point_lights", "shadow_rays", "alpha_shadows", "environment_map",
    "environment_mis", "material_diffuse_white",
    "material_use_geometric_normals", "material_mis", "show_nan", "show_inf",
    "shading_normal_adaptation", "cull_backface", "use_frame_as_seed",
)
_PT_INTS = ("min_bounces", "max_bounces", "debug_output", "max_accumulated_frames")
_PARAM_FIELDS = (
    "environment_intensity", "luminance_clamp",
    "min_russian_roulette_continue_prob", "max_russian_roulette_continue_prob",
    "fixed_seed",
)


def _apply_setting(renderer, field: str, value) -> bool:
    """One Graphics-tab control change -> renderer settings/params."""
    import dataclasses

    from gltf_renderer_tpu_torch.render import settings as S

    st = renderer.settings
    if field in _PT_BOOLS:
        pt = dataclasses.replace(st.pt, **{field: bool(value)})
    elif field in _PT_INTS:
        v = int(value)
        if field in ("min_bounces", "max_bounces"):
            # UI clamps to the hard cap (Pathtracer.h:102; Main.cpp sliders).
            v = max(0, min(v, S.MAX_BOUNCES_HARD_CAP))
        pt = dataclasses.replace(st.pt, **{field: v})
        if pt.min_bounces > pt.max_bounces:
            if field == "min_bounces":
                pt = dataclasses.replace(pt, max_bounces=pt.min_bounces)
            else:
                pt = dataclasses.replace(pt, min_bounces=pt.max_bounces)
    elif field in _PARAM_FIELDS:
        v = int(value) if field == "fixed_seed" else float(value)
        renderer.params = renderer.params._replace(**{field: v})
        return True
    elif field == "tonemapper":
        tm = dataclasses.replace(
            st.tonemap,
            tonemapper=S.TONEMAPPER_AGX if value in (1, "1", "agx") else S.TONEMAPPER_NONE,
        )
        renderer.settings = dataclasses.replace(st, tonemap=tm)
        return True
    elif field == "exposure":
        tm = dataclasses.replace(st.tonemap, exposure=float(value))
        renderer.settings = dataclasses.replace(st, tonemap=tm)
        return True
    elif field == "bloom_enabled":
        renderer.settings = dataclasses.replace(
            st, bloom=dataclasses.replace(st.bloom, enabled=bool(value)))
        return True
    elif field == "bloom_strength":
        renderer.settings = dataclasses.replace(
            st, bloom=dataclasses.replace(st.bloom, strength=float(value)))
        return True
    elif field == "backend":
        renderer.settings = dataclasses.replace(st, backend=str(value))
        return True
    else:
        logging.warning("unknown setting %r", field)
        return False
    renderer.settings = dataclasses.replace(st, pt=pt)
    return True


def _settings_dict(renderer):
    """Graphics-tab state snapshot for /state (UI sync + tests)."""
    st = renderer.settings
    d = {f: getattr(st.pt, f) for f in _PT_BOOLS + _PT_INTS}
    d.update({f: float(getattr(renderer.params, f)) for f in _PARAM_FIELDS})
    d["tonemapper"] = st.tonemap.tonemapper
    d["exposure"] = st.tonemap.exposure
    d["bloom_enabled"] = st.bloom.enabled
    d["bloom_strength"] = st.bloom.strength
    return d


def _apply_inputs(state: ViewerState, evs) -> bool:
    """Reference CameraController semantics: yaw/pitch per pixel dragged,
    exponential dolly, pan in view plane. Returns True if the camera moved."""
    moved = False
    orbit = state.orbit
    free = state.free
    for ev in evs:
        t = ev.get("type")
        if t == "orbit":
            if state.cam_mode == "free":
                # Fly-cam look: negative sensitivity per pixel
                # (CameraController.h:193-196, rotation_sensitivity 0.001).
                free.rotate(-0.001 * float(ev.get("dx", 0)),
                            -0.001 * float(ev.get("dy", 0)))
            else:
                orbit.rotate(float(ev.get("dx", 0)) * 0.005,
                             float(ev.get("dy", 0)) * 0.005)
            moved = True
        elif t == "dolly":
            if state.cam_mode == "free":
                # Wheel adjusts fly speed, not position (:180-182): 0.3 per
                # notch; browser deltaY is ~120/notch and inverted.
                free.increase_speed(-0.3 * float(ev.get("amount", 0)) / 120.0)
            else:
                orbit.zoom(0.001 * float(ev.get("amount", 0)) * max(orbit.radius, 1e-3))
            moved = True
        elif t == "pan":
            orbit.pan(float(ev.get("dx", 0)) * 0.002,
                      float(ev.get("dy", 0)) * 0.002)
            moved = True
        elif t == "key":
            # WASD+QE fly movement with LSHIFT boost (Tick, :202-227).
            if state.cam_mode == "free":
                keys = {str(k).lower() for k in ev.get("keys", [])}
                free.move(
                    forward=("w" in keys) - ("s" in keys),
                    right=("d" in keys) - ("a" in keys),
                    up=("e" in keys) - ("q" in keys),
                    dt=float(ev.get("dt", 1 / 60)),
                    fast=bool(ev.get("shift", False)),
                )
                moved = True
        elif t == "mode":
            want = str(ev.get("value", "orbit"))
            if want != state.cam_mode and want in ("orbit", "free"):
                if want == "free":
                    # Seed the fly-cam at the orbit eye so the toggle is
                    # seamless: same rotation composition, eye = the point
                    # the orbit view maps to the view-space origin.
                    import numpy as _np

                    eye = _np.linalg.inv(orbit.world_to_view()) @ _np.array(
                        [0.0, 0.0, 0.0, 1.0], _np.float32)
                    free.position = eye[:3].astype(_np.float32)
                    free.azimuth = orbit.azimuth
                    free.inclination = float(_np.clip(
                        orbit.inclination, -_np.pi / 2, _np.pi / 2))
                state.cam_mode = want
                moved = True
        elif t == "backend":
            import dataclasses
            st = state.renderer.settings
            state.renderer.settings = dataclasses.replace(
                st, backend=("rasterizer" if st.backend == "pathtracer"
                             else "pathtracer"))
            moved = True
        elif t == "set":
            moved |= _apply_setting(
                state.renderer, str(ev.get("field", "")), ev.get("value"))
        elif t == "animation":
            # glTF-tab animation combo (Main.cpp:196-222): index or null.
            idx = ev.get("index", None)
            try:
                state.renderer.select_animation(
                    None if idx is None else int(idx))
                moved = True
            except (IndexError, ValueError) as e:
                logging.error("animation select failed: %s", e)
        elif t == "anim":
            # Transport: play/pause, loop, scrub (AnimationPlayer fields).
            p = state.renderer.player
            if "playing" in ev:
                p.playing = bool(ev["playing"])
            if "looping" in ev:
                p.looping = bool(ev["looping"])
            if "time" in ev:
                p.time = float(ev["time"])
                moved = True
        elif t == "scene":
            # glTF-tab scene selector (Main.cpp:190-200).
            try:
                state.renderer.select_scene(int(ev.get("index", 0)))
                moved = True
            except (IndexError, ValueError) as e:
                logging.error("scene select failed: %s", e)
        elif t == "camera":
            idx = ev.get("index", None)
            try:
                state.renderer.select_camera(
                    None if idx is None else int(idx),
                    viewport_aspect=state.width / state.height)
                moved = True
            except (IndexError, ValueError) as e:
                logging.error("camera select failed: %s", e)
        elif t == "load":
            # Load-by-path AND the drag-drop upload path (Main.cpp:367-406
            # drop semantics: .gltf/.glb replace the scene, .exr/.hdr the
            # environment).
            try:
                p = str(ev.get("path", ""))
                if p.lower().endswith((".exr", ".hdr")):
                    state.renderer.load_environment(p)
                else:
                    state.renderer.load_scene(p)
                    state.scene_path = p
                moved = True
            except Exception as e:  # drag-drop of a bad file must not kill the loop
                logging.error("load failed: %s", e)
    if moved:
        active = free if state.cam_mode == "free" else orbit
        state.renderer.camera.world_to_view = active.world_to_view()
    return moved


def render_loop(state: ViewerState, max_spp: int = 512):
    """The Main.cpp frame loop: poll input -> update camera -> draw -> blit.
    Progressive accumulation continues while the camera is still; input
    resets it (the Renderer's reset-on-change key does this automatically).
    An exception stops the loop: it is kept in state.error (shown by /state)
    and raised again."""
    try:
        _frames(state, max_spp)
    except BaseException as e:
        state.error = f"{type(e).__name__}: {e}"
        state.running = False
        raise


def _frames(state: ViewerState, max_spp: int):
    from PIL import Image

    last = time.perf_counter()
    while state.running:
        evs = state.take_inputs()
        _apply_inputs(state, evs)
        p = state.renderer.player
        animating = p.animation is not None and p.playing
        now = time.perf_counter()
        delta, last = (now - last), now
        if not animating and state.renderer.accumulated_frames >= max_spp and not evs:
            time.sleep(0.05)
            continue
        img = state.renderer.draw_frame(delta=delta if animating else 0.0)
        buf = io.BytesIO()
        Image.fromarray(np.asarray(img)).save(buf, format="PNG")
        state.publish(buf.getvalue(), state.renderer.accumulated_frames)


def _snapshot_history(history, last: int = 60):
    """Copy the renderer's live counter deque without racing the render
    thread (CPython raises RuntimeError if the deque is appended to during
    iteration; appends themselves are atomic)."""
    for _ in range(4):
        try:
            return list(history)[-last:]
        except RuntimeError:
            continue
    return []


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif path == "/frame.png":
                with state.lock:
                    png, seq = state.frame_png, state.frame_seq
                if not png:
                    self._send(503, b"no frame yet", "text/plain")
                else:
                    self._send(200, png, "image/png",
                               [("X-Frame-Seq", str(seq))])
            elif path == "/state":
                r = state.renderer
                scn = r.scene
                body = json.dumps({
                    "frame": state.frame_seq,
                    "spp": int(state.spp),
                    "backend": r.settings.backend,
                    "scene": state.scene_path,
                    "settings": _settings_dict(r),
                    "animations": len(scn.animations) if scn else 0,
                    "scenes": len(scn.scenes) if scn else 0,
                    "scene_id": getattr(r, "scene_id", 0),
                    "cameras": len(scn.cameras) if scn else 0,
                    "cam_mode": state.cam_mode,
                    "orbit": [float(state.orbit.azimuth), float(state.orbit.inclination),
                              float(state.orbit.radius)],
                    "animation_playing": bool(r.player.playing),
                    "animation_time": float(r.player.time),
                    # Always-on counter plots (Tracy analogue): last frames'
                    # wall ms + spp, plus the scene memory pool size.
                    # (deque iteration races the render thread's append —
                    # RuntimeError 'mutated during iteration' — so retry.)
                    "history": _snapshot_history(r.history),
                    "stats": {k: v for k, v in r.stats.items()
                              if k != "pass_ms"},
                    "running": bool(state.running),
                    "error": state.error,
                }).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"", "text/plain")

        def do_POST(self):
            path = self.path.split("?")[0]
            n = int(self.headers.get("Content-Length", 0))
            if path == "/upload":
                # Drag-drop upload (SDL_EVENT_DROP_FILE analogue,
                # Main.cpp:367-406): raw file body + ?name=<filename>.
                # Saved to a session temp dir, then queued as a load event.
                import tempfile
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                name = os.path.basename(q.get("name", ["dropped.glb"])[0])
                ext = os.path.splitext(name)[1].lower()
                if ext not in (".gltf", ".glb", ".exr", ".hdr"):
                    self._send(415, b"unsupported file type", "text/plain")
                    return
                if not hasattr(state, "_upload_dir"):
                    state._upload_dir = tempfile.mkdtemp(prefix="gltf_upload_")
                dst = os.path.join(state._upload_dir, name)
                with open(dst, "wb") as f:
                    remaining = n
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 20))
                        if not chunk:
                            break
                        f.write(chunk)
                        remaining -= len(chunk)
                if ext == ".gltf":
                    # Only the dropped file arrives — a .gltf whose buffers
                    # or images reference sibling files cannot load from the
                    # empty temp dir. Reject with a useful message instead
                    # of silently keeping the old scene (.glb embeds all).
                    try:
                        with open(dst, "r", encoding="utf-8") as f:
                            doc = json.load(f)
                        ext_uri = [
                            u for u in (
                                [b.get("uri", "") for b in doc.get("buffers", [])]
                                + [i.get("uri", "") for i in doc.get("images", [])]
                            )
                            if u and not u.startswith("data:")
                        ]
                    except ValueError:
                        self._send(415, b"not valid glTF JSON", "text/plain")
                        return
                    if ext_uri:
                        self._send(
                            415,
                            b"gltf references external files; drop a .glb "
                            b"(or use load-by-path)", "text/plain",
                        )
                        return
                state.post_input({"type": "load", "path": dst})
                self._send(200, b"ok", "text/plain")
                return
            if path != "/input":
                self._send(404, b"", "text/plain")
                return
            try:
                ev = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                ev = {}
            state.post_input(ev)
            self._send(200, b"ok", "text/plain")

    return Handler


def serve(gltf_path, width=960, height=540, port=8008, backend="pathtracer",
          env_path=None, block=True, shard="off", device="cuda", host="0.0.0.0"):
    """Build the renderer on `device`, start the render thread + HTTP server
    on (host, port); port 0 binds a free port (read it from
    server.server_address).

    Returns (server, state, thread) when block=False (tests drive it)."""
    from gltf_renderer_tpu_torch.app.cli import scene_bounds
    from gltf_renderer_tpu_torch.camera import OrbitController
    from gltf_renderer_tpu_torch.render import settings as S
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    settings = S.RenderSettings(backend=backend, width=width, height=height)
    renderer = Renderer(settings, mesh="auto" if shard == "auto" else None, device=device)
    scene = renderer.load_scene(gltf_path)
    if env_path:
        renderer.load_environment(env_path)

    # Frame the scene like the CLI does (bounds of the flattened world).
    center, radius = scene_bounds(scene)
    orbit = OrbitController(centre=center, radius=2.5 * radius)
    renderer.camera.aspect_ratio = width / height
    renderer.camera.z_near = max(1e-3, 0.01 * radius)
    renderer.camera.world_to_view = orbit.world_to_view()

    state = ViewerState(renderer, orbit, width, height)
    state.scene_path = str(gltf_path)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    thread = threading.Thread(target=render_loop, args=(state,), daemon=True)
    thread.start()
    logging.info("viewer on http://localhost:%d (scene: %s)", server.server_address[1],
                 gltf_path)
    if not block:
        srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
        srv_thread.start()
        return server, state, thread
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.running = False
    return None


def main(argv=None, device="cuda"):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("gltf")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--height", type=int, default=540)
    parser.add_argument("--backend", default="pathtracer",
                        choices=["pathtracer", "rasterizer"])
    parser.add_argument("--environment-map", default=None)
    parser.add_argument("--shard", choices=["off", "auto"], default="off",
                        help="auto: shard frames over every visible device (one device: "
                             "unsharded; several: not ported yet)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    serve(args.gltf, args.width, args.height, args.port, args.backend,
          args.environment_map, shard=args.shard, device=device)


if __name__ == "__main__":
    main()
