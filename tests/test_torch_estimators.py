"""The JAX package's estimator and cross-backend checks, held against the
port on the CPU, at those tests' sizes, sample counts and bars:

- tests/test_pt_env.py: the environment seen by missed rays (bounces 0,
  4 spp, 32x32); NEE+MIS and BSDF-only sampling converging to the same
  mean on the lit box (2 bounces, 48 spp each, the mean over pixels
  [8:24, 8:24] within 12% a channel); and, over 16 frames, the per-pixel
  variance with NEE+MIS finite and, beyond the JAX test, below BSDF-only
  sampling's (at the mean check's 2 bounces, where the JAX test takes 1);
- tests/test_crossvalidate.py: the raster frame against the converged path
  tracer (3 bounces, 48 spp, 32x32) on the diffuse box (global SSIM > 0.9)
  and on the two-slot multi-UV scene (> 0.85), means within 15%; the
  compact material rows sampled against the loader's full rows (atol
  1e-6, the presence flags equal);
- tests/test_ssim_baseline.py::test_furnace_raster_vs_converged_pt: the
  diffuse box under a uniform environment, raster against the path
  tracer converged at 256 spp with 4 bounces (64x64): windowed SSIM >= 0.99
  after a 4x4 box downsample, means within 2% (bench_scene.furnace_scores).

Every scene is built as its JAX test builds it, by the JAX package (loader,
flatten, environment, make_pt_scene, with the port's BVH builder and the
knobs of tests/test_torch_raster_shading.py), and carried to the port
(`convert.from_jax_pt_scene`): both packages read the same tables (the
path-tracer-only scene without the raster prefilters, which the path
tracer does not read). Beside each bar the JAX function runs on the same
inputs: the miss render, the three raster frames, the slot sampler, and
one sample of every path-tracer configuration the converged renders use
(2 bounces with and without env NEE+MIS, 3 bounces on each cross-check
scene, the furnace's 4), held to the port's sample at the same seed. The
port meets the path tracer's bar (98% of pixels within atol 1e-4 + rtol
1e-3, the mean within 1%) and the raster bar of
tests/test_torch_raster_blend.py (99.5%, 0.1%). One jitted JAX trace
serves the file, so a configuration compiles once. The converged
renders are the port's (the JAX path tracer takes about as long as its
compile for each of them); its converged path tracer takes its samples
through trace_chunked (sample k of a dispatch keyed by seed +
k * SEED_STRIDE), not the JAX tests' seeds 0..spp-1: the same estimator,
another draw of the noise.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.camera import Camera, look_at
from gltf_renderer_tpu.env import environment as E
from gltf_renderer_tpu.render import pathtracer as jpt
from gltf_renderer_tpu.render import rasterizer as jrz
from gltf_renderer_tpu.render import settings as JS
from gltf_renderer_tpu.scene.gltf import load_gltf
from gltf_renderer_tpu_torch import convert
from gltf_renderer_tpu_torch.bench_scene import FURNACE_PT, FURNACE_RADIANCE, furnace_scores
from gltf_renderer_tpu_torch.ops import material as pmat
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.render import rasterizer as prz
from gltf_renderer_tpu_torch.render import settings as PS
from tests.scenes import write_box_gltf
from tests.test_crossvalidate import ssim as global_ssim
from tests.test_env import _test_equirect
from tests.test_torch_alpha import jax_pt_scene
from tests.test_torch_pathtracer import _assert_images_match
from tests.test_torch_raster_blend import _assert_frames_match
from tests.test_torch_raster_shading import RASTER_KNOBS
from tests.test_torch_scene import jax_env, jax_knobs

torch.set_num_threads(2)
RES = 32
FURNACE_RES = 64
_JAX_TRACE = jax.jit(jpt.trace, static_argnums=(1, 2, 5))


def _scenes(env_fn, *views):
    """For each (glTF path, eye) of `views`: {JAX PTScene, PTMeta, port
    PTScene, PTMeta, clip_to_world, camera position, loaded Scene} of the
    file under env_fn()'s environment (built once), by the JAX package,
    seen from `eye` at the origin with the JAX tests' camera."""
    out = []
    with pytest.MonkeyPatch.context() as mp:
        jax_knobs(mp)
        for k, v in RASTER_KNOBS.items():
            mp.setenv(k, v)
        env = env_fn()
        for path, eye in views:
            src = load_gltf(path)
            jscene, jmeta, _, _ = jax_pt_scene(src, env)
            jscene = jax.tree.map(jnp.asarray, jscene)
            pscene, pmeta = convert.from_jax_pt_scene(jax.tree.map(np.asarray, jscene), jmeta,
                                                      "cpu")
            cam = Camera(y_fov=np.pi / 3, aspect_ratio=1.0, z_near=0.01)
            cam.world_to_view = look_at(eye, [0.0, 0.0, 0.0])
            out.append(dict(jscene=jscene, jmeta=jmeta, pscene=pscene, pmeta=pmeta,
                            c2w=np.asarray(cam.clip_to_world(), np.float32),
                            cam_pos=np.asarray(cam.position(), np.float32), src=src))
    return out


def _lowrange_eq():
    """test_crossvalidate's smooth low-dynamic-range environment."""
    h, w = 32, 64
    z = 1.0 - 2.0 * ((np.arange(h) + 0.5) / h)[:, None] * np.ones((1, w))
    return np.stack([0.5 + 0.2 * z, 0.5 + 0.1 * z, 0.5 - 0.1 * z], -1).astype(np.float32)


@pytest.fixture(scope="module")
def env_box(tmp_path_factory):
    path = write_box_gltf(str(tmp_path_factory.mktemp("env") / "box.gltf"),
                          base_color=(0.7, 0.7, 0.7, 1.0), roughness=0.9, with_light=False)
    return _scenes(lambda: jax_env(_test_equirect(), 64), (path, [1.8, -1.8, 1.2]))[0]


@pytest.fixture(scope="module")
def crossval(tmp_path_factory):
    """test_crossvalidate's two scenes, each with its JAX raster frame."""
    from gltf_renderer_tpu.scene.procedural import write_multiuv_gltf

    d = tmp_path_factory.mktemp("cross")
    box = write_box_gltf(str(d / "box.gltf"), base_color=(0.6, 0.55, 0.5, 1.0), roughness=1.0,
                         with_light=False)
    scenes = _scenes(lambda: E.build_environment(_lowrange_eq(), cube_size=32),
                     (box, [2.0, -2.0, 1.5]),
                     (write_multiuv_gltf(str(d / "multiuv.gltf")), [1.5, -1.5, 1.2]))
    for sc in scenes:
        sc["jax_raster"] = _jax_raster(sc, RES)
    return dict(zip(("box", "multislot"), scenes))


@pytest.fixture(scope="module")
def furnace(tmp_path_factory):
    path = write_box_gltf(str(tmp_path_factory.mktemp("furnace") / "box.gltf"),
                          base_color=(0.65, 0.65, 0.65, 1.0), roughness=1.0, with_light=False)
    eq = np.full((16, 32, 3), FURNACE_RADIANCE, np.float32)  # uniform furnace environment
    sc = _scenes(lambda: E.build_environment(eq, cube_size=16), (path, [2.0, -2.0, 1.5]))[0]
    sc["jax_raster"] = _jax_raster(sc, FURNACE_RES)
    return sc


def _jax_raster(sc, res):
    return np.asarray(jrz.render(sc["jscene"], sc["jmeta"], JS.RenderSettings(),
                                 JS.PathTracerParams(), jnp.asarray(sc["c2w"]),
                                 jnp.asarray(sc["cam_pos"]), (res, res), jnp.uint32(0)))


def _port_raster(sc, res):
    return prz.render(sc["pscene"], sc["pmeta"], PS.RenderSettings(), PS.PathTracerParams(),
                      sc["c2w"], sc["cam_pos"], (res, res), 0).numpy()


def _port_samples(sc, settings, seeds, res=RES):
    """(n, res, res, 3): the port's sample of each seed."""
    return np.stack([ppt.trace(sc["pscene"], sc["pmeta"], settings, PS.PathTracerParams(),
                               sc["c2w"], (res, res), s).numpy() for s in seeds])


def _port_converged(sc, settings, spp, res=RES):
    """The port's mean of `spp` samples a pixel, one trace_chunked dispatch
    (float64 mean of float32 samples, as the JAX tests accumulate)."""
    img, stats = ppt.trace_chunked(sc["pscene"], sc["pmeta"], settings, PS.PathTracerParams(),
                                   sc["c2w"], (res, res), 0, with_stats=True, spp=spp,
                                   chunk=min(spp * res * res, ppt.RAY_CHUNK))
    assert float(stats[1]) == 0.0
    return img.numpy().astype(np.float64)


def _assert_sample_matches_jax(sc, settings, res=RES, seed=0):
    """The port's sample at `seed` under `settings` (keyword arguments of
    PathTracerSettings) against the JAX path tracer's on the same inputs."""
    got = ppt.trace(sc["pscene"], sc["pmeta"], PS.PathTracerSettings(**settings),
                    PS.PathTracerParams(), sc["c2w"], (res, res), seed).numpy()
    want = _JAX_TRACE(sc["jscene"], sc["jmeta"], JS.PathTracerSettings(**settings),
                      JS.PathTracerParams(), jnp.asarray(sc["c2w"]), (res, res), jnp.uint32(seed))
    _assert_images_match(got, np.asarray(want))


def _env_settings(bounces, **kw):
    return dict(max_bounces=bounces, min_bounces=bounces, luminance_clamp_enabled=False,
                point_lights=False, **kw)


def test_env_miss_background(env_box):
    kw = dict(max_bounces=0, min_bounces=0, environment_mis=False)
    img = _port_samples(env_box, PS.PathTracerSettings(**kw), range(4)).mean(0)
    assert np.all(np.isfinite(img))
    assert img[0, 0].max() > 0.05  # background pixels show the environment
    want = np.mean([np.asarray(_JAX_TRACE(env_box["jscene"], env_box["jmeta"],
                                          JS.PathTracerSettings(**kw), JS.PathTracerParams(),
                                          jnp.asarray(env_box["c2w"]), (RES, RES),
                                          jnp.uint32(s)))
                    for s in range(4)], 0)
    _assert_images_match(img, want)


def test_env_mis_unbiased(env_box):
    for mis in (True, False):
        _assert_sample_matches_jax(env_box, _env_settings(2, environment_mis=mis))
    base = PS.PathTracerSettings(**_env_settings(2))
    with_mis = _port_converged(env_box, base, 48)
    no_nee = _port_converged(env_box, dataclasses.replace(base, environment_mis=False), 48)
    a = with_mis[8:24, 8:24].mean(axis=(0, 1))
    b = no_nee[8:24, 8:24].mean(axis=(0, 1))
    rel = np.abs(a - b) / np.maximum(b, 1e-3)
    assert np.all(rel < 0.12), (a, b)


def test_env_nee_reduces_variance(env_box):
    base = PS.PathTracerSettings(**_env_settings(2))  # test_env_mis_unbiased's, held to JAX
    var = {mis: _port_samples(env_box, dataclasses.replace(base, environment_mis=mis),
                              range(16)).var(0).mean() for mis in (True, False)}
    assert np.isfinite(var[True])
    assert var[True] < var[False], var


@pytest.mark.parametrize("name, bar", [("box", 0.9), ("multislot", 0.85)])
def test_raster_vs_converged_pt(crossval, name, bar):
    sc = crossval[name]
    if name == "multislot":
        assert len(sc["pmeta"].used_slots) >= 2, sc["pmeta"].used_slots
    raster = _port_raster(sc, RES)
    _assert_frames_match(raster, sc["jax_raster"])
    _assert_sample_matches_jax(sc, _env_settings(3))
    traced = _port_converged(sc, PS.PathTracerSettings(**_env_settings(3)), 48)
    s = global_ssim(raster, traced)
    assert s > bar, s
    rel = abs(raster.mean() - traced.mean()) / traced.mean()
    assert rel < 0.15, (raster.mean(), traced.mean())


def test_compact_rows_match_full_rows(crossval):
    """The port's compact rows (compact_material_rows of the loader's full
    rows) are the JAX package's, and sample_slots_fused on them gives what
    the JAX package samples from the full rows."""
    from gltf_renderer_tpu.ops.material import sample_slots_fused

    sc = crossval["multislot"]
    src, jscene, slots = sc["src"], sc["jscene"], sc["pmeta"].used_slots
    full = np.asarray(src.materials.rows)
    compact = pmat.compact_material_rows(full, slots, np.asarray(jscene.textures.rows))
    np.testing.assert_array_equal(compact.view(np.int32),
                                  np.asarray(jscene.materials.rows).view(np.int32))
    n = 64
    rng = np.random.RandomState(7)
    uv = rng.rand(n, 2).astype(np.float32)
    sample_full = jax.jit(lambda row, textures, uv: sample_slots_fused(
        row, textures, slots, uv, uv, slots, False))
    for mat in range(full.shape[0]):
        want = sample_full(jnp.asarray(full[np.full(n, mat)]), jscene.textures, jnp.asarray(uv))
        got = pmat.sample_slots_fused(torch.from_numpy(compact[np.full(n, mat)]),
                                      sc["pscene"].textures, slots, torch.from_numpy(uv),
                                      torch.from_numpy(uv), slots)
        for s in slots:
            np.testing.assert_allclose(got[s][0].numpy(), np.asarray(want[s][0]), atol=1e-6,
                                       err_msg=f"slot {s} material {mat}")
            np.testing.assert_array_equal(got[s][1].numpy(), np.asarray(want[s][1]))


def test_furnace_raster_vs_converged_pt(furnace):
    raster = _port_raster(furnace, FURNACE_RES)
    _assert_frames_match(raster, furnace["jax_raster"])
    _assert_sample_matches_jax(furnace, FURNACE_PT, FURNACE_RES)
    traced = _port_converged(furnace, PS.PathTracerSettings(**FURNACE_PT), 256, FURNACE_RES)
    score, rel = furnace_scores(raster, traced)
    assert score >= 0.99, score
    assert rel < 0.02, rel
