"""The port's punctual lights (ops/lights.py and light NEE in the path
tracer) against the JAX package.

- `get_light_ray` on a random light table (numpy seed) of point, spot and
  directional lights, with and without a range cutoff, at random surface
  points: directions and colours within 1e-6 relative to each array's
  largest value (the falloff's fourth power and the spot cosines round
  differently under XLA's fused multiply-adds); `sample_point_light` picks
  the same light index with the same pdf.
- A box with one KHR point light under the environment (`write_box_gltf`,
  the camera of the box golden configuration): the whole `trace`, which
  runs the merged bounce + env-shadow + light-shadow launch (2r shadow
  lanes) and draws the light sample between the env and the bounce samples,
  at the bar of tests/test_torch_pathtracer.py (at least 98% of pixels
  within atol 1e-4 + rtol 1e-3, the mean within 1%).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.ops import lights as jlights
from gltf_renderer_tpu.render import pathtracer as jpt
from gltf_renderer_tpu.render import settings as JS
from gltf_renderer_tpu.scene import types as JT
from gltf_renderer_tpu_torch import camera
from gltf_renderer_tpu_torch.bench_scene import analytic_sky
from gltf_renderer_tpu_torch.ops import lights as plights
from gltf_renderer_tpu_torch.ops import traverse as tr
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.render import settings as PS
from gltf_renderer_tpu_torch.scene import types as PT
from tests.test_torch_alpha import both
from tests.test_torch_pathtracer import _assert_images_match
from tests.test_torch_scene import SKY_HW, jax_env

torch.set_num_threads(2)
BOX_RES = (64, 36)
N_LIGHTS = 6
N_POINTS = 4096


def _light_table(seed, with_cutoff):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N_LIGHTS, 3))
    cols = dict(
        type=np.asarray([0, 1, 2, 0, 1, 2], np.int32),
        position=rng.uniform(-3, 3, (N_LIGHTS, 3)).astype(np.float32),
        direction=(d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
        color=rng.uniform(0.2, 1.0, (N_LIGHTS, 3)).astype(np.float32),
        intensity=rng.uniform(1.0, 50.0, N_LIGHTS).astype(np.float32),
        cutoff=(rng.uniform(2.0, 8.0, N_LIGHTS) * with_cutoff).astype(np.float32),
        inner_angle=rng.uniform(0.0, 0.3, N_LIGHTS).astype(np.float32),
        outer_angle=rng.uniform(0.4, 1.2, N_LIGHTS).astype(np.float32),
    )
    return (JT.GpuLights(**{k: jnp.asarray(v) for k, v in cols.items()}),
            PT.GpuLights(**{k: torch.as_tensor(v) for k, v in cols.items()}), rng)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_light_type_constants_match():
    assert (PT.LIGHT_TYPE_POINT, PT.LIGHT_TYPE_SPOT, PT.LIGHT_TYPE_DIRECTIONAL) == \
        (JT.LIGHT_TYPE_POINT, JT.LIGHT_TYPE_SPOT, JT.LIGHT_TYPE_DIRECTIONAL)


@pytest.mark.parametrize("with_cutoff", [False, True])
def test_get_light_ray_matches_jax(with_cutoff):
    jl, pl, rng = _light_table(7, with_cutoff)
    idx = rng.integers(0, N_LIGHTS, N_POINTS).astype(np.int32)
    pos = rng.uniform(-4, 4, (N_POINTS, 3)).astype(np.float32)
    want = jlights.get_light_ray(jl, jnp.asarray(idx), jnp.asarray(pos))
    got = plights.get_light_ray(pl, torch.as_tensor(idx), torch.as_tensor(pos))
    _close(got.direction.numpy(), want.direction)
    _close(got.color.numpy(), want.color)
    spot = idx == PT.LIGHT_TYPE_SPOT
    lit = (got.color.numpy() > 0).any(-1)
    assert lit[spot].any() and (~lit[spot]).any()  # inside and outside the cones


def test_sample_point_light_matches_jax():
    jl, pl, rng = _light_table(8, True)
    pos = rng.uniform(-4, 4, (N_POINTS, 3)).astype(np.float32)
    u = rng.random(N_POINTS).astype(np.float32)
    want, want_pdf = jlights.sample_point_light(jl, N_LIGHTS, jnp.asarray(pos), jnp.asarray(u))
    got, got_pdf = plights.sample_point_light(pl, N_LIGHTS, torch.as_tensor(pos),
                                              torch.as_tensor(u))
    assert got_pdf == want_pdf == 1.0 / N_LIGHTS
    _close(got.direction.numpy(), want.direction)
    _close(got.color.numpy(), want.color)


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    from gltf_renderer_tpu.scene.gltf import load_gltf
    from gltf_renderer_tpu.scene.procedural import write_box_gltf

    src = load_gltf(write_box_gltf(str(tmp_path_factory.mktemp("box") / "box.gltf")))
    return both(src, env=jax_env(analytic_sky(*SKY_HW)))


@pytest.fixture(scope="module")
def jax_trace():
    return jax.jit(jpt.trace, static_argnums=(1, 2, 5))


@pytest.mark.parametrize("seed", [1, 2])
def test_box_light_and_env_trace_matches_jax(box, jax_trace, seed):
    assert box["pmeta"].num_lights == 1 and not box["pmeta"].has_alpha_layer
    c2w = camera.clip_to_world(camera.look_at([2.0, -2.0, 1.5], [0.0, 0.0, 0.0]),
                               y_fov=np.pi / 3, aspect=BOX_RES[0] / BOX_RES[1], z_near=0.01)
    jset = JS.PathTracerSettings(max_bounces=2, min_bounces=2)
    pset = PS.PathTracerSettings(max_bounces=2, min_bounces=2)
    want = np.asarray(jax_trace(box["jscene"], box["jmeta"], jset, JS.PathTracerParams(),
                                jnp.asarray(c2w), BOX_RES, jnp.uint32(seed)))
    calls = tr.REFERENCE_CALLS
    got, stats = ppt.trace(box["pscene"], box["pmeta"], pset, PS.PathTracerParams(), c2w,
                           BOX_RES, seed, with_stats=True)
    # Primary, two merged bounce launches (bounce + env + light lanes), and
    # the last bounce's light shadow on its own.
    assert tr.REFERENCE_CALLS == calls + 4
    got = got.numpy()
    assert np.isfinite(got).all() and float(stats[1]) == 0.0
    _assert_images_match(got, want)


def test_unmerged_light_shadows_give_the_same_image(box):
    """merged_light_dispatch=False traces the light's binary shadow rays in
    their own any-hit launch: the same image, one more launch a bounce."""
    c2w = camera.clip_to_world(camera.look_at([2.0, -2.0, 1.5], [0.0, 0.0, 0.0]),
                               y_fov=np.pi / 3, aspect=BOX_RES[0] / BOX_RES[1], z_near=0.01)
    imgs, launches = [], []
    for merged in (True, False):
        calls = tr.REFERENCE_CALLS
        imgs.append(ppt.trace(box["pscene"], box["pmeta"],
                              PS.PathTracerSettings(merged_light_dispatch=merged),
                              PS.PathTracerParams(), c2w, BOX_RES, 3))
        launches.append(tr.REFERENCE_CALLS - calls)
    torch.testing.assert_close(imgs[0], imgs[1], rtol=0, atol=0)
    assert launches == [4, 6]
