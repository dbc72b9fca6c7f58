"""The torch port's path-tracer slice as a whole, against the JAX package.

`trace` at 64x36 on the low-tessellation bench-style scene, with the same
tables in both packages (convert.from_jax_pt_scene), compared per pixel.
The bar: at least 98% of pixels within atol 1e-4 + rtol 1e-3, and the image
mean within 1%. The remaining pixels are path flips — a sample that lands
on the other side of a decision boundary (a Russian-roulette or layer
threshold, a triangle edge) because sin/cos/pow and the reference's fused
multiply-adds move the last bits — and one flipped sample dominates a
pixel at 1 spp.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.render import pathtracer as jpt
from gltf_renderer_tpu_torch import convert
from gltf_renderer_tpu_torch.bench_scene import bench_camera, build_bench_scene
from gltf_renderer_tpu_torch.ops import traverse as tr
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from tests.test_torch_scene import (
    CUBE_SIZE,
    DIFFUSE_SIZE,
    SKY_HW,
    SPHERE,
    build_jax_bench_scene,
    jax_knobs,
    jax_settings,
    port_settings,
)

torch.set_num_threads(2)
RES = (64, 36)
M32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        jax_knobs(mp)
        _, _, jscene, jmeta = build_jax_bench_scene(str(tmp_path_factory.mktemp("pt")))
    pscene, pmeta = convert.from_jax_pt_scene(jax.tree.map(np.asarray, jscene), jmeta, "cpu")
    return jscene, jmeta, pscene, pmeta


@pytest.fixture(scope="module")
def jax_trace():
    return jax.jit(jpt.trace, static_argnums=(1, 2, 5))


def _assert_images_match(got, want):
    close = np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)
    frac = close.all(-1).mean()
    assert frac >= 0.98, frac
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


@pytest.mark.parametrize("seed", [1, 2])
def test_trace_matches_jax(scenes, jax_trace, seed):
    jscene, jmeta, pscene, pmeta = scenes
    jset, jparams = jax_settings()
    pset, pparams = port_settings()
    c2w = bench_camera(*RES)
    want = np.asarray(jax_trace(jscene, jmeta, jset, jparams, jnp.asarray(c2w), RES,
                                jnp.uint32(seed)))
    got, stats = ppt.trace(pscene, pmeta, pset, pparams, c2w, RES, seed, with_stats=True)
    got = got.numpy()
    assert got.shape == (RES[1], RES[0], 3) and np.isfinite(got).all()
    assert float(stats[1]) == 0.0 and float(stats[0]) >= RES[0] * RES[1]
    _assert_images_match(got, want)


def test_port_built_scene_traces_like_jax(scenes, jax_trace):
    """The whole port — its own scene, BVH and environment build — against
    the JAX package's render of the same configuration."""
    jscene, jmeta, _, _ = scenes
    jset, jparams = jax_settings()
    pscene, pmeta, pset, pparams, c2w, n_tris = build_bench_scene(
        *RES, device="cpu", tex_size=SPHERE["tex_size"], n_lat=SPHERE["n_lat"],
        n_lon=SPHERE["n_lon"], sky_hw=SKY_HW, cube_size=CUBE_SIZE, diffuse_size=DIFFUSE_SIZE)
    assert n_tris == np.asarray(jscene.world.tri_vertex).shape[0]
    want = np.asarray(jax_trace(jscene, jmeta, jset, jparams, jnp.asarray(c2w), RES,
                                jnp.uint32(3)))
    got = ppt.trace(pscene, pmeta, pset, pparams, c2w, RES, 3).numpy()
    _assert_images_match(got, want)


def test_trace_chunked_spp_is_mean_of_seed_schedule(scenes):
    _, _, pscene, pmeta = scenes
    pset, pparams = port_settings()
    c2w = bench_camera(*RES)
    seed = 0xFFFFFFF0  # the schedule wraps past 2^32
    got = ppt.trace_chunked(pscene, pmeta, pset, pparams, c2w, RES, seed, spp=2, chunk=8192)
    a = ppt.trace(pscene, pmeta, pset, pparams, c2w, RES, seed)
    b = ppt.trace(pscene, pmeta, pset, pparams, c2w, RES, (seed + 0x9E3779B9) & M32)
    torch.testing.assert_close(got, (a + b) / 2, rtol=0, atol=0)
    assert not torch.equal(a, b)


def test_cpu_path_launches_no_kernel(scenes):
    _, _, pscene, pmeta = scenes
    pset, pparams = port_settings()
    calls = tr.REFERENCE_CALLS
    ppt.trace(pscene, pmeta, pset, pparams, bench_camera(*RES), RES, 4)
    assert tr.KERNEL_LAUNCHES == 0
    assert tr.REFERENCE_CALLS == calls + 3  # primary + two merged bounce/shadow launches


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gltf_renderer_tpu_torch.device import resolve
    from gltf_renderer_tpu_torch.env.environment import build_environment_pt

    with pytest.raises(RuntimeError):
        resolve("cuda")
    with pytest.raises(RuntimeError):
        build_environment_pt(np.ones((8, 16, 3), np.float32), cube_size=8, device="cuda")


def test_entry_points_default_to_the_card():
    """Called without `device`, the entry points ask for the card: on a host
    without one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gltf_renderer_tpu_torch.bench_scene import world_from_scene
    from gltf_renderer_tpu_torch.env.environment import build_environment_pt
    from gltf_renderer_tpu_torch.scene.procedural import textured_sphere_scene

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_environment_pt(np.ones((8, 16, 3), np.float32), cube_size=8)
    scene = textured_sphere_scene(tex_size=8, n_lat=4, n_lon=8)
    world, lights = world_from_scene(scene)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ppt.make_pt_scene(world, scene.materials, scene.textures, lights)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bench_scene(16, 9, tex_size=8, n_lat=4, n_lon=8, sky_hw=(8, 16), cube_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_jax_pt_scene(None, None)


def test_forced_layer_flags_trace_the_same_image(scenes):
    """Every BSDF layer forced on for a scene without them traces the image
    the scene's own flags give, bit for bit (an absent layer is skipped for
    its ops only)."""
    _, _, pscene, pmeta = scenes
    pset, pparams = port_settings()
    assert not (pmeta.has_sheen or pmeta.has_clearcoat or pmeta.has_transmission)
    base = ppt.trace(pscene, pmeta, pset, pparams, bench_camera(*RES), RES, 1)
    for change in (dict(has_sheen=True), dict(has_clearcoat=True), dict(has_transmission=True)):
        got = ppt.trace(pscene, pmeta._replace(**change), pset, pparams, bench_camera(*RES),
                        RES, 1)
        assert torch.equal(got.view(torch.int32), base.view(torch.int32)), change


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import gltf_renderer_tpu_torch.render.pathtracer\n"
        "import gltf_renderer_tpu_torch.ops.lights\n"
        "import gltf_renderer_tpu_torch.bench_scene\n"
        "import gltf_renderer_tpu_torch.convert\n"
        "import gltf_renderer_tpu_torch.ops.raster\n"
        "import gltf_renderer_tpu_torch.render.rasterizer\n"
        "import gltf_renderer_tpu_torch.render.renderer\n"
        "import gltf_renderer_tpu_torch.post.bloom\n"
        "import gltf_renderer_tpu_torch.post.tonemap\n"
        "import gltf_renderer_tpu_torch.profile_raster\n"
        "import gltf_renderer_tpu_torch.ops.brute\n"
        "import gltf_renderer_tpu_torch.ops.perlane\n"
        "import gltf_renderer_tpu_torch.ops.warm\n"
        "import gltf_renderer_tpu_torch.bench\n"
        "import gltf_renderer_tpu_torch.tools.bench_mxu\n"
        "import gltf_renderer_tpu_torch.tools.bench_perlane\n"
        "import gltf_renderer_tpu_torch.tools.bench_traverse\n"
        "import gltf_renderer_tpu_torch.tools.bench_launch\n"
        "import gltf_renderer_tpu_torch.tools.count_ops\n"
        "import gltf_renderer_tpu_torch.scene.gltf\n"
        "import gltf_renderer_tpu_torch.scene.textures\n"
        "import gltf_renderer_tpu_torch.env.hdr_io\n"
        "import gltf_renderer_tpu_torch.env.piz\n"
        "import gltf_renderer_tpu_torch.anim.animation\n"
        "import gltf_renderer_tpu_torch.anim.skinning\n"
        "import gltf_renderer_tpu_torch.utils.scene_cache\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'gltf_renderer_tpu' or m.startswith('gltf_renderer_tpu.')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=root, env=env, check=True, timeout=120)
