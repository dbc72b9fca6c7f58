"""Frames of the port's Renderer against the JAX Renderer's, on the same
files written by the JAX writers (tests/scenes.py) at 48x32, 1 bounce, the
port on the CPU.

Cases: the box path-traced (two accumulated frames), the unlit box under
an environment, the box through an orthographic camera, the skinned strip
and the morph cube at delta 0 and then delta 1 (the second frame refits
the tables to the new pose and restarts accumulation), and the box
rasterized. After each frame the HDR accumulation (the raster frame's HDR
image) is held to the path tracer's CPU bar, at least 98% of pixels within
atol 1e-4 + rtol 1e-3 and the means within 1% (tests/test_torch_pathtracer.py,
chip_smoke.images_match), or to the raster bar, 99.5% and 0.1%
(tests/test_torch_raster_frame.py); the u8 frames, tone-mapped and
dithered by each package, within one count on at least 99% of pixels
(AgX's log2 and pow can cross a rounding boundary).

The environment case builds JAX's environment from its cube, mip and
importance steps without the two raster prefilters, which the path tracer
never samples (JAX's build_environment has no option to skip the
256x256x6 diffuse prefilter, ~25 s on this CPU); the port's is the
port's build_environment with prefilters=False, assigned to the Renderer
as the JAX one's is (load_environment, like JAX's, always builds both
prefilters).
"""

import numpy as np
import pytest
import torch

from gltf_renderer_tpu.camera import look_at
from gltf_renderer_tpu.render import renderer as jrend
from gltf_renderer_tpu.render import settings as JS
from gltf_renderer_tpu_torch.env.environment import build_environment
from gltf_renderer_tpu_torch.render import renderer as prend
from gltf_renderer_tpu_torch.render import settings as PS
from tests.scenes import write_box_gltf, write_morph_gltf, write_skinned_gltf
from tests.test_env import _test_equirect

torch.set_num_threads(2)
W, H = 48, 32
VIEWS = {"skinned": ([0.0, -3.0, 1.0], [0.0, 0.0, 1.0])}
DEFAULT_VIEW = ([2.0, -2.0, 1.5], [0.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    return {"box": write_box_gltf(str(d / "box.gltf")),
            "box_unlit": write_box_gltf(str(d / "unlit.gltf"), with_light=False),
            "skinned": write_skinned_gltf(str(d / "skin.gltf")),
            "morph": write_morph_gltf(str(d / "morph.gltf"))}


def _jax_pt_env(equirect):
    """JAX EnvMaps with the path tracer's tables (cube mips, importance,
    alias rows) and no raster prefilters."""
    import jax.numpy as jnp

    from gltf_renderer_tpu.env import environment as jenv
    from gltf_renderer_tpu.ops import sampling as jsampling

    eq = jnp.asarray(equirect, jnp.float32)
    cube_mips = jenv.build_cube_mips(jenv.build_cubemap(eq, 64))
    importance = jenv.build_importance_map(cube_mips[0], cube_mips[1:])
    return jenv.EnvMaps(cube=cube_mips, ggx=None, diffuse=None, importance=importance,
                        equirect=eq, importance_quads=jsampling.pack_importance_quads(importance),
                        alias_rows=jnp.asarray(jsampling.build_alias_rows(
                            np.asarray(importance[0]))))


def make(pkg, path, backend="pathtracer", view=DEFAULT_VIEW):
    S = JS if pkg == "jax" else PS
    rs = S.RenderSettings(backend=backend, width=W, height=H,
                          pt=S.PathTracerSettings(max_bounces=1, min_bounces=1))
    r = jrend.Renderer(rs) if pkg == "jax" else prend.Renderer(rs, device="cpu")
    r.load_scene(path)
    r.camera.aspect_ratio = W / H
    r.camera.z_near = 0.01
    r.camera.world_to_view = look_at(*view)
    return r


def _orthographic(r):
    r.camera.type = "orthographic"
    r.camera.x_mag = r.camera.y_mag = 0.8
    r.camera.z_near, r.camera.z_far = 0.05, 10.0


# case: (file, backend, deltas of the frames drawn, set-up of both renderers)
CASES = {
    "box": ("box", "pathtracer", (0.0, 0.0), None),
    "environment": ("box_unlit", "pathtracer", (0.0, 0.0), "env"),
    "orthographic": ("box", "pathtracer", (0.0,), _orthographic),
    "skinned": ("skinned", "pathtracer", (0.0, 1.0), None),
    "morph": ("morph", "pathtracer", (0.0, 1.0), None),
    "raster": ("box", "rasterizer", (0.0,), None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_frames_match_jax(name, files):
    path, backend, deltas, setup = CASES[name]
    view = VIEWS.get(name, DEFAULT_VIEW)
    j, p = make("jax", files[path], backend, view), make("port", files[path], backend, view)
    if setup == "env":
        eq = _test_equirect()
        j.env, j._ptscene = _jax_pt_env(eq), None
        p.env, p._ptscene = build_environment(eq, device="cpu", prefilters=False), None
    elif setup is not None:
        setup(j)
        setup(p)
    share, mean_rel = (0.995, 0.001) if backend == "rasterizer" else (0.98, 0.01)
    for delta in deltas:
        a, b = j.draw_frame(delta=delta), p.draw_frame(delta=delta)
        assert (j.accumulated_frames, j.frame_index) == (p.accumulated_frames, p.frame_index)
        want, got = np.asarray(j._accum), p._accum.numpy()
        assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
        close = (np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)).all(-1).mean()
        rel = abs(float(got.mean()) - float(want.mean())) / abs(float(want.mean()))
        u8 = (np.abs(a.astype(int) - b.astype(int)) <= 1).all(-1).mean()
        print(f"{name} delta={delta}: close {close:.5f} mean rel {rel:.2e} u8 within 1 {u8:.5f}")
        assert close >= share and rel <= mean_rel
        assert a.dtype == b.dtype == np.uint8 and u8 >= 0.99
        assert got.std() > 0
