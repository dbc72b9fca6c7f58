"""The port's BASELINE config 5 tool (gltf_renderer_tpu_torch/tools/
render_config5.py) on the CPU, against the JAX package's tool
(tools/render_config5.py).

- Resume: two sessions of `run` (3 frames, then resumed to 6, a
  checkpoint every 3) end with exactly the accumulation bits, u8 image,
  accumulated_frames and frame_index of one uninterrupted 6-frame session,
  on a small textured-sphere GLB at 64x36 under a small analytic sky; the
  progress JSON carries the JAX tool's keys.
- Set-up: `main` builds what the JAX tool's main builds before its loop:
  the courtyard GLB at density 1, the render settings field for field,
  the analytic sky bit for bit, the camera (lens, view and clip_to_world),
  and the warm-up launch. Both mains run with the heavy steps recorded
  instead of done (GLB write, scene load, environment build, the JAX
  warm-up and the loop itself).
- The default device is the card: without one `main` raises.
- tools/config5_bf16_rows rounds the port's hit-attribute rows as the JAX
  package's bf16 rows hold them (GLTF_TPU_BF16ROWS=1), past the
  positions, bit for bit, on the textured sphere; positions and the
  material and flag words stay as they were.
- tools/compare_config5 reads the tool's output: against its own PNG,
  SSIM 1 and no difference; against a darkened copy, the u8 difference
  and a low SSIM.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gltf_renderer_tpu_torch.bench_scene import analytic_sky
from gltf_renderer_tpu_torch.env.environment import build_environment
from gltf_renderer_tpu_torch.scene.procedural import write_textured_sphere_glb
from gltf_renderer_tpu_torch.tools import render_config5 as tool

torch.set_num_threads(2)
W, H = 64, 36
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL_KEYS = {"spp", "target_spp", "wall_s", "resolution", "scene",
                 "s_per_sample_this_session"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    glb = write_textured_sphere_glb(str(tmp_path_factory.mktemp("c5") / "sphere.glb"),
                                    tex_size=16, n_lat=8, n_lon=16)
    env = build_environment(analytic_sky(16, 32), cube_size=16, device="cpu", diffuse_size=8)
    return glb, env


def _session(small, frames, out):
    r = tool.make_renderer(small[0], W, H, "cpu", env=small[1])
    tool.run(r, frames, 3, str(out))
    return r


def _files(out):
    with np.load(out / tool.CKPT) as ck:
        state = {k: ck[k] for k in ck.files}
    with open(out / tool.PROGRESS) as f:
        progress = json.load(f)
    return state, np.asarray(Image.open(out / tool.PNG)), progress


def test_resumed_sessions_are_one_session(small, tmp_path):
    whole = _session(small, 6, tmp_path / "whole")
    _session(small, 3, tmp_path / "cut")
    first = _files(tmp_path / "cut")[2]
    resumed = _session(small, 6, tmp_path / "cut")
    assert torch.equal(resumed._accum, whole._accum)
    assert (resumed.accumulated_frames, resumed.frame_index) == (6, 6)
    assert (whole.accumulated_frames, whole.frame_index) == (6, 6)
    (a, img_a, prog_a), (b, img_b, prog_b) = _files(tmp_path / "whole"), _files(tmp_path / "cut")
    assert a["accum"].tobytes() == b["accum"].tobytes()
    assert a["accum"].tobytes() == whole._accum.numpy().tobytes()
    assert [int(a[k]) for k in ("accumulated_frames", "frame_index")] == [6, 6]
    assert [int(b[k]) for k in ("accumulated_frames", "frame_index")] == [6, 6]
    assert img_a.shape == (H, W, 3) and img_a.std() > 0
    np.testing.assert_array_equal(img_b, img_a)
    for prog in (first, prog_a, prog_b):
        assert JAX_TOOL_KEYS <= set(prog)
        assert prog["resolution"] == [W, H] and prog["scene"] == tool.SCENE
    assert (first["spp"], prog_a["spp"], prog_b["spp"]) == (3, 6, 6)
    assert prog_b["target_spp"] == 6 and prog_b["frames_this_session"] == 3
    assert prog_b["wall_s"] > first["wall_s"] > 0
    assert not [n for n in os.listdir(tmp_path / "cut") if n.startswith(".partial")]
    # A session whose checkpoint already holds the target draws nothing more.
    assert tool.run(tool.make_renderer(small[0], W, H, "cpu", env=small[1]), 6, 3,
                    str(tmp_path / "cut")) is None


class _Stop(Exception):
    pass


def _recorder(monkeypatch, cls, got):
    monkeypatch.setattr(cls, "load_scene", lambda self, p: got.setdefault("scene", p))
    monkeypatch.setattr(cls, "load_environment",
                        lambda self, eq: got.setdefault("sky", np.array(eq)))


def _port_setup(monkeypatch, tmp_path):
    from gltf_renderer_tpu_torch.ops import warm
    from gltf_renderer_tpu_torch.render.renderer import Renderer
    from gltf_renderer_tpu_torch.scene import procedural

    got = {}
    real_warm = warm.warm
    monkeypatch.setattr(warm, "warm", lambda device: got.setdefault("warm", real_warm(device)))
    monkeypatch.setattr(procedural, "write_courtyard_glb",
                        lambda path, **kw: got.setdefault("glb", (os.path.basename(path), kw))[0])
    _recorder(monkeypatch, Renderer, got)
    monkeypatch.setattr(tool, "run", lambda r, *a: got.setdefault("run", (r, a)))
    assert tool.main(["--out", str(tmp_path / "port")], device="cpu") == 0
    return got


def _jax_setup(monkeypatch, tmp_path):
    import bench
    from gltf_renderer_tpu.render.renderer import Renderer
    from gltf_renderer_tpu.scene import procedural

    got = {}
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["render_config5.py", "--out", str(tmp_path / "jax")])
    monkeypatch.setattr(bench, "_warm_pallas", lambda: got.setdefault("warm", True))
    monkeypatch.setattr(procedural, "write_courtyard_glb",
                        lambda path, **kw: got.setdefault("glb", (os.path.basename(path), kw))[0])
    _recorder(monkeypatch, Renderer, got)

    def stop(self, *a, **kw):
        got["renderer"] = self
        raise _Stop

    monkeypatch.setattr(Renderer, "draw_frame", stop)
    spec = importlib.util.spec_from_file_location(
        "jax_render_config5", os.path.join(ROOT, "tools", "render_config5.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(_Stop):
        mod.main()
    return got


def test_setup_is_the_jax_tools(monkeypatch, tmp_path):
    port = _port_setup(monkeypatch, tmp_path)
    jax = _jax_setup(monkeypatch, tmp_path)
    pr, run_args = port["run"]
    jr = jax["renderer"]
    assert run_args == (1024, 32, str(tmp_path / "port"))
    assert port["glb"] == jax["glb"] == ("courtyard.glb", {"density": 1})
    assert port["scene"].endswith("courtyard.glb") and jax["scene"].endswith("courtyard.glb")
    assert port["warm"].shape == (8, 128) and jax["warm"] is True
    assert dataclasses.asdict(pr.settings) == dataclasses.asdict(jr.settings)
    assert (pr.settings.width, pr.settings.height) == (1920, 1080)
    assert port["sky"].dtype == jax["sky"].dtype == np.float32
    assert port["sky"].tobytes() == jax["sky"].tobytes()
    for field in ("type", "y_fov", "aspect_ratio", "z_near", "z_far"):
        assert getattr(pr.camera, field) == getattr(jr.camera, field), field
    assert np.asarray(pr.camera.world_to_view).tobytes() == \
        np.asarray(jr.camera.world_to_view).tobytes()
    assert pr.camera.clip_to_world().tobytes() == jr.camera.clip_to_world().tobytes()
    assert tool.build_parser().parse_args([]).out == os.path.join("build", "config5_torch")


def test_main_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--frames", "1", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_compare_reads_the_tools_output(small, tmp_path):
    from gltf_renderer_tpu_torch.tools import compare_config5

    out = tmp_path / "out"
    _session(small, 2, out)
    img = np.asarray(Image.open(out / tool.PNG))
    got = compare_config5.compare(str(out), str(out / tool.PNG))
    assert (got["spp"], got["frame_index"], got["resolution"]) == (2, 2, [W, H])
    assert (got["hdr_nan"], got["hdr_inf"], got["mean_abs_u8"], got["max_abs_u8"]) == (0, 0, 0, 0)
    assert got["ssim"] == pytest.approx(1.0, abs=1e-12)
    dark = tmp_path / "dark.png"
    Image.fromarray(img // 2).save(dark)
    got = compare_config5.compare(str(out), str(dark))
    assert got["mean_abs_u8"] == pytest.approx(float((img - img // 2).mean()))
    assert got["max_abs_u8"] == int((img - img // 2).max()) and got["ssim"] < 0.99


def test_bf16_rows_are_the_jax_packages(small, monkeypatch):
    import jax
    import jax.numpy as jnp

    from gltf_renderer_tpu.scene import flatten as jf
    from gltf_renderer_tpu.scene.gltf import load_gltf as jax_load_gltf
    from gltf_renderer_tpu_torch.bench_scene import world_from_scene
    from gltf_renderer_tpu_torch.scene.gltf import load_gltf
    from gltf_renderer_tpu_torch.tools.config5_bf16_rows import ROW, round_rows

    monkeypatch.setenv("GLTF_TPU_BF16ROWS", "1")
    src = jax_load_gltf(small[0])
    tf = jf.compute_global_transforms(src)
    plan = jf.build_instance_plan(src)
    jrows = np.asarray(jf.build_world_geometry(
        jax.tree.map(jnp.asarray, src.pools), plan, jnp.asarray(tf),
        jnp.asarray(jf.normal_transforms(tf)), jf.plan_tri_flags(plan, src.primitives)
    ).tri_attr_rows)
    assert jrows.dtype == jnp.bfloat16
    world = world_from_scene(load_gltf(small[0]))[0]
    rows = np.asarray(world.tri_attr_rows)
    got = np.asarray(round_rows(world).tri_attr_rows)
    assert got.dtype == np.float32 and got.shape == rows.shape
    for k in range(0, 3 * ROW, ROW):
        pos, rest = slice(k, k + 3), slice(k + 3, k + ROW)
        assert got[:, pos].tobytes() == rows[:, pos].tobytes()
        assert got[:, rest].tobytes() == jrows[:, rest].astype(np.float32).tobytes()
        assert not np.array_equal(got[:, rest], rows[:, rest])  # something was rounded
    assert got[:, 3 * ROW:].tobytes() == rows[:, 3 * ROW:].tobytes()
