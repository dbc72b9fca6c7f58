"""The port's Renderer (gltf_renderer_tpu_torch/render/renderer.py) against
the JAX package's, on the same files written by the JAX writers
(tests/scenes.py) at 48x32, the port on the CPU.

- The state machine, exactly: after each call, accumulated_frames,
  frame_index, the selected scene, the animation time, the camera's
  world_to_clip (bit for bit) and the seed and frame count each path-tracer
  sample was given, over eight scripts: a camera move, settings / params
  changes (the tone map is outside the reset key in both), an animation
  time change, max_accumulated_frames holding accumulation,
  use_frame_as_seed=False with fixed_seed (and an explicit seed),
  select_scene on a two-scene document (an out-of-range index raises
  IndexError before any state changes), select_camera following an
  animated camera node, and select_animation(None). The JAX renderer's
  path-tracer step is replaced by one that records its arguments and
  returns the accumulation unchanged (nothing of the state machine reads
  the image); the port's runs for real.
- Checkpoints: the port's save_state -> load_state resumes bit-identically
  (u8 frame and HDR accumulation); a JAX checkpoint resumes in the port and
  a port checkpoint in JAX, the third sample's accumulation within the path
  tracer's CPU bar (98% of pixels within atol 1e-4 + rtol 1e-3, means
  within 1%, as tests/test_torch_pathtracer.py).
- profile: pass_ms, stats and history carry the JAX renderer's keys, on
  both backends, and exactly these beside them: the port's span names in
  pass_ms and `counts` in stats.
- Meshes: mesh="auto" without a process group renders unsharded; an
  explicit mesh (parallel.sharding.make_mesh) is used as given, and its
  path-tracer and raster frames equal the unsharded renderer's bit for
  bit (u8, HDR and ray_stats); a mesh on another device type, an unknown
  mesh string and a sharded tiled-visibility frame raise ValueError; a
  rank other than 0 writes no checkpoint. The default device is the card,
  and without one the Renderer raises.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gltf_renderer_tpu.camera import look_at
from gltf_renderer_tpu.render import renderer as jrend
from gltf_renderer_tpu.render import settings as JS
from gltf_renderer_tpu_torch.render import renderer as prend
from gltf_renderer_tpu_torch.render import settings as PS
from tests.scenes import (
    write_box_gltf,
    write_camera_anim_gltf,
    write_skinned_gltf,
)

torch.set_num_threads(2)
W, H = 48, 32
EYE = ([2.0, -2.0, 1.5], [0.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("renderer")
    two = str(d / "two_scenes.gltf")
    write_box_gltf(two)
    doc = json.load(open(two))
    doc["nodes"].append({"mesh": 0, "name": "box2", "translation": [0.0, 0.0, 3.0]})
    doc["scenes"].append({"nodes": [len(doc["nodes"]) - 1]})
    json.dump(doc, open(two, "w"))
    return {"box": write_box_gltf(str(d / "box.gltf")),
            "skinned": write_skinned_gltf(str(d / "skin.gltf")),
            "camera_anim": write_camera_anim_gltf(str(d / "cam.gltf")),
            "two_scenes": two}


def make(pkg, path, backend="pathtracer", **pt_kw):
    """A renderer of either package on `path`, 1 bounce, the golden lens,
    looking from EYE."""
    S = JS if pkg == "jax" else PS
    rs = S.RenderSettings(backend=backend, width=W, height=H,
                          pt=S.PathTracerSettings(**dict(dict(max_bounces=1, min_bounces=1),
                                                         **pt_kw)))
    r = jrend.Renderer(rs) if pkg == "jax" else prend.Renderer(rs, device="cpu")
    r.load_scene(path)
    r.camera.aspect_ratio = W / H
    r.camera.z_near = 0.01
    r.camera.world_to_view = look_at(*EYE)
    return r


def record_samples(pkg, r, monkeypatch):
    """[(seed, accumulated_frames)] of every path-tracer sample `r` takes.
    JAX's step is replaced by a recorder that returns the accumulation."""
    seen = []
    if pkg == "jax":
        def step(ptscene, meta, settings, params, c2w, resolution, seed, accum, frames):
            seen.append((int(seed), int(frames)))
            return accum

        monkeypatch.setattr(jrend, "_pt_step", step)
    else:
        real = r._pt_step

        def step(c2w, resolution, seed):
            seen.append((int(seed), r.accumulated_frames))
            return real(c2w, resolution, seed)

        r._pt_step = step
    return seen


def _state(r, seen):
    return (r.accumulated_frames, r.frame_index, r.scene_id, float(r.player.time),
            r.player.animation is None, np.asarray(r.camera.world_to_clip()).tobytes(),
            tuple(seen))


def _camera_move(r, rec, files):
    for _ in range(2):
        r.draw_frame()
        rec()
    r.camera.world_to_view = look_at([2.2, -2.0, 1.5], [0, 0, 0])
    for _ in range(2):
        r.draw_frame()
        rec()


def _settings_change(r, rec, files):
    r.draw_frame()
    r.draw_frame()
    rec()
    r.settings = dataclasses.replace(r.settings, pt=dataclasses.replace(r.settings.pt,
                                                                        max_bounces=0,
                                                                        min_bounces=0))
    r.draw_frame()
    rec()
    r.params = r.params._replace(environment_intensity=0.5)
    r.draw_frame()
    rec()
    r.params = r.params._replace(environment_color=(0.2, 0.3, 0.4))
    r.draw_frame()
    rec()
    r.settings = dataclasses.replace(r.settings, tonemap=dataclasses.replace(
        r.settings.tonemap, exposure=2.0))  # not in the reset key
    r.draw_frame()
    rec()


def _animation_time(r, rec, files):
    for delta in (0.0, 0.0, 0.25, 0.0):
        r.draw_frame(delta=delta)
        rec()
    r.player.playing = False
    r.draw_frame(delta=0.5)  # paused: the time holds, accumulation goes on
    rec()


def _max_accumulated(r, rec, files):
    for _ in range(4):
        r.draw_frame()
        rec()


def _fixed_seed(r, rec, files):
    r.params = r.params._replace(fixed_seed=7)
    for _ in range(2):
        r.draw_frame()
        rec()
    r.params = r.params._replace(fixed_seed=9)
    r.draw_frame()
    rec()
    r.draw_frame(seed=123)
    rec()


def _select_scene(r, rec, files):
    r.draw_frame()
    rec()
    r.select_scene(1)
    rec()
    r.draw_frame()
    rec()
    with pytest.raises(IndexError):
        r.select_scene(99)
    rec()
    r.draw_frame()
    rec()


def _select_camera(r, rec, files):
    assert r.scene.cameras
    r.select_animation(0)
    r.select_camera(0, viewport_aspect=W / H)
    rec()
    for delta in (0.0, 0.0, 1.0):
        r.draw_frame(delta=delta)
        rec()
    r.select_camera(None)
    r.draw_frame(delta=0.0)
    rec()


def _select_animation_none(r, rec, files):
    r.draw_frame(delta=0.5)
    rec()
    r.select_animation(None)
    rec()
    for _ in range(2):
        r.draw_frame(delta=0.3)
        rec()


SCRIPTS = {
    "camera_move": ("box", {}, _camera_move),
    "settings_change": ("box", {}, _settings_change),
    "animation_time": ("skinned", {}, _animation_time),
    "max_accumulated": ("box", dict(max_accumulated_frames=2), _max_accumulated),
    "fixed_seed": ("box", dict(use_frame_as_seed=False), _fixed_seed),
    "select_scene": ("two_scenes", {}, _select_scene),
    "select_camera": ("camera_anim", {}, _select_camera),
    "select_animation_none": ("skinned", {}, _select_animation_none),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_state_machine_matches_jax(name, files, monkeypatch):
    scene, pt_kw, script = SCRIPTS[name]
    states = {}
    for pkg in ("jax", "port"):
        r = make(pkg, files[scene], **pt_kw)
        seen = record_samples(pkg, r, monkeypatch)
        states[pkg] = []
        script(r, lambda: states[pkg].append(_state(r, seen)), files)
        if pkg == "port" and name == "max_accumulated":
            held = r._accum.clone()
            r.draw_frame()
            assert torch.equal(held, r._accum)  # accumulation holds at the cap
    assert len(states["jax"]) == len(states["port"]) > 0
    for k, (a, b) in enumerate(zip(states["jax"], states["port"])):
        assert a == b, (name, k, a[:5], b[:5], a[6], b[6])


def test_fixed_seed_repeats_the_sample(files):
    """use_frame_as_seed=False: every pass takes the pinned seed, so the
    running mean stays the first sample, bit for bit (the port's own
    check of tests/test_renderer.py::test_use_frame_as_seed_off)."""
    r = make("port", files["box"], use_frame_as_seed=False)
    r.draw_frame()
    first = r._accum.clone()
    r.draw_frame()
    assert torch.equal(first, r._accum)
    on = make("port", files["box"])
    on.draw_frame()
    a = on._accum.clone()
    on.draw_frame()
    assert not torch.equal(a, on._accum)


def _images_match(got, want, share=0.98, mean_rel=0.01):
    close = np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)
    assert close.all(-1).mean() >= share, close.all(-1).mean()
    assert abs(got.mean() - want.mean()) <= mean_rel * abs(want.mean())


def test_checkpoint_resumes_bit_identically(files, tmp_path):
    """ROADMAP item 5's gate on the CPU: two frames, save_state, the third
    frame; a fresh renderer (primed with a frame of its own) load_state's
    and draws the same third frame, u8 and HDR bit for bit."""
    r1 = make("port", files["box"])
    r1.draw_frame()
    r1.draw_frame()
    ckpt = str(tmp_path / "state.npz")
    r1.save_state(ckpt)
    expected = r1.draw_frame()
    r2 = make("port", files["box"])
    r2.draw_frame()
    r2.load_state(ckpt)
    assert (r2.accumulated_frames, r2.frame_index) == (2, 2)
    assert r2._accum.device.type == "cpu"
    resumed = r2.draw_frame()
    np.testing.assert_array_equal(resumed, expected)
    assert torch.equal(r2._accum, r1._accum)
    assert set(np.load(ckpt).files) == {"accum", "accumulated_frames", "frame_index"}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(direction, files, tmp_path):
    """The .npz keys are the JAX renderer's: a checkpoint of either package
    resumes in the other, and the third sample's accumulation agrees with
    the writer's own third within the path tracer's bar."""
    src, dst = direction.split("_to_")
    a = make(src, files["box"])
    a.draw_frame()
    a.draw_frame()
    ckpt = str(tmp_path / "state.npz")
    a.save_state(ckpt)
    a.draw_frame()
    b = make(dst, files["box"])
    b.load_state(ckpt)
    b.draw_frame()
    assert a.accumulated_frames == b.accumulated_frames == 3
    assert a.frame_index == b.frame_index == 3
    _images_match(np.asarray(b._accum), np.asarray(a._accum))


@pytest.mark.parametrize("backend", ["pathtracer", "rasterizer"])
def test_profile_and_stats_keys_match_jax(backend, files, monkeypatch):
    """The port's keys are the JAX renderer's plus its own spans in pass_ms
    (render/renderer.py's docstring: the u8 copy and the path tracer's
    spans that ran: the opaque box has no alpha loop, so no
    `pt.alpha_read`) and its `counts` in stats."""
    keys = {}
    for pkg in ("jax", "port"):
        r = make(pkg, files["box"], backend=backend)
        if backend == "pathtracer":
            record_samples(pkg, r, monkeypatch)
        r.profile = True
        r.draw_frame()
        keys[pkg] = (set(r.stats), set(r.stats["pass_ms"]), set(r.history[-1]),
                     r.stats["triangles"], r.stats["backend"], len(r.history))
        assert all(v >= 0 for v in r.stats["pass_ms"].values())
        assert r.stats["scene_bytes"] > 0 and r.stats["frame_ms"] > 0
    spans = {"u8_copy", "pt.k1"} | ({"pt.chunk", "pt.shade", "pt.nee", "pt.bsdf_sample"}
                                    if backend == "pathtracer" else set())
    stats, pass_ms, *rest = keys["jax"]
    assert keys["port"] == (stats | {"counts"}, pass_ms | spans, *rest)


def test_sharding_requests(files, tmp_path):
    from gltf_renderer_tpu_torch.parallel import sharding

    r = prend.Renderer(PS.RenderSettings(width=W, height=H), mesh="auto", device="cpu")
    assert r.mesh is None
    r.load_scene(files["box"])
    assert r.draw_frame().shape == (H, W, 3)
    mesh = sharding.make_mesh(1, 4, device="cpu")
    assert prend.Renderer(mesh=mesh, device="cpu").mesh is mesh
    with pytest.raises(ValueError, match="'everywhere'"):
        prend.Renderer(mesh="everywhere", device="cpu")
    on_card = sharding.Mesh(1, 1, 0, 1, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="the mesh is on cuda:0"):
        prend.Renderer(mesh=on_card, device="cpu")
    tiled = make("port", files["box"], backend="rasterizer")
    tiled.mesh, tiled.raster_visibility = mesh, "tiled"
    with pytest.raises(ValueError, match="raycast"):
        tiled.draw_frame()
    # Rank 1 of 2 writes no checkpoint; rank 0 does.
    r.mesh = sharding.Mesh(1, 2, 1, 2, torch.device("cpu"))
    r.save_state(str(tmp_path / "rank1.npz"))
    assert not (tmp_path / "rank1.npz").exists()
    r.mesh = sharding.Mesh(1, 2, 0, 2, torch.device("cpu"))
    r.save_state(str(tmp_path / "rank0.npz"))
    assert (tmp_path / "rank0.npz").exists()


@pytest.mark.parametrize("backend", ["pathtracer", "rasterizer"])
def test_sharded_frames_equal_unsharded(backend, files):
    """Renderer(mesh=make_mesh(1, 4)): 4 row tiles of 8 drawn in turn and
    gathered, two frames, equal to the unsharded renderer's bit for bit."""
    from gltf_renderer_tpu_torch.parallel import sharding

    single = make("port", files["box"], backend=backend)
    sharded = make("port", files["box"], backend=backend)
    sharded.mesh = sharding.make_mesh(1, 4, device="cpu")
    for _ in range(2):
        want, got = single.draw_frame(), sharded.draw_frame()
        np.testing.assert_array_equal(got, want)
        assert torch.equal(sharded._accum, single._accum)
    assert torch.equal(sharded.ray_stats, single.ray_stats)
    assert "collective_ms" in sharded.stats and "collective_ms" not in single.stats


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prend.Renderer()
