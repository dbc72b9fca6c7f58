"""The courtyard bench scene in the port against the JAX package.

`write_courtyard_glb(tex_size=64)` read by the JAX loader, at the size of
the courtyard golden configuration (tests/golden_configs.py:112-121):
- the port's in-memory `courtyard_scene(tex_size=64)` gives the loader's
  pools, material, texture and light tables and atlas, and through the
  port's flatten and scene build the same world rows, BVH tables, compact
  material rows and linear atlas, bit for bit;
- `trace` at 64x36 with 2 bounces and alpha shadows, seeds 1 and 2, on the
  same tables in both packages, at the bar of tests/test_torch_pathtracer.py
  (at least 98% of pixels within atol 1e-4 + rtol 1e-3, the mean within
  1%); the masked-retry loop runs, so rays reach the banners;
- the golden configuration drawn through the port's Renderer from the
  port's courtyard GLB (`render_courtyard_golden`)
  against tests/goldens/courtyard_pt.png at the SSIM bar of
  tests/test_ssim_baseline.py (0.99).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.render import pathtracer as jpt
from gltf_renderer_tpu.render import settings as JS
from gltf_renderer_tpu_torch.bench_scene import (
    analytic_equirect,
    bench_camera,
    render_courtyard_golden,
    world_from_scene,
)
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.render import settings as PS
from gltf_renderer_tpu_torch.scene.procedural import courtyard_scene
from gltf_renderer_tpu_torch.utils.ssim import ssim
from tests.test_torch_alpha import both
from tests.test_torch_pathtracer import _assert_images_match
from tests.test_torch_scene import bits, jax_env

torch.set_num_threads(2)
RES = (64, 36)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "courtyard_pt.png")


@pytest.fixture(scope="module")
def court(tmp_path_factory):
    from gltf_renderer_tpu.scene.gltf import load_gltf
    from gltf_renderer_tpu.scene.procedural import write_courtyard_glb

    src = load_gltf(write_courtyard_glb(str(tmp_path_factory.mktemp("court") / "c.glb"),
                                        tex_size=64))
    return both(src, env=jax_env(analytic_equirect()))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(bits(a), bits(b))


def test_courtyard_scene_tables_equal_loader(court):
    j, p = court["src"], courtyard_scene(tex_size=64)
    for f in p.pools._fields:
        _eq(getattr(j.pools, f), getattr(p.pools, f))
    for f in p.primitives._fields:
        _eq(getattr(j.primitives, f), getattr(p.primitives, f))
    _eq(j.materials.rows, p.materials.rows)
    _eq(j.textures.rows, p.textures.rows)
    _eq(j.textures.atlas, p.textures.atlas)
    _eq(j.topo_order, p.topo_order)
    world, lights = world_from_scene(p)
    assert world.tri_vertex.shape[0] == 273856 and len(lights.type) == 0
    for f in world._fields:
        _eq(getattr(court["world"], f), getattr(world, f))
    ps, pm = ppt.make_pt_scene(world, p.materials, p.textures, lights, device="cpu")
    js, jm = court["jscene"], court["jmeta"]
    _eq(js.materials.rows, ps.materials.rows.numpy())
    _eq(js.textures.rows, ps.textures.rows.numpy())
    _eq(js.textures.atlas_linear, ps.textures.atlas_linear.numpy())
    _eq(js.wide_nodes, ps.wide_nodes.numpy())
    _eq(js.leaf_records, ps.leaf_records.numpy())
    _eq(js.leaf_words, ps.leaf_words.numpy())
    for f in jm._fields:
        if f != "has_env":
            assert getattr(jm, f) == getattr(pm, f), f
    assert pm.has_masked and pm.has_alpha_layer and not pm.has_blend


@pytest.mark.parametrize("seed", [1, 2])
def test_courtyard_trace_matches_jax(court, seed):
    settings = dict(max_bounces=2, min_bounces=2, alpha_shadows=True)
    c2w = bench_camera(*RES, "courtyard")
    want = np.asarray(jax.jit(jpt.trace, static_argnums=(1, 2, 5))(
        court["jscene"], court["jmeta"], JS.PathTracerSettings(**settings),
        JS.PathTracerParams(), jnp.asarray(c2w), RES, jnp.uint32(seed)))
    hops = ppt.ALPHA_RETRY_HOPS
    got, stats = ppt.trace(court["pscene"], court["pmeta"], PS.PathTracerSettings(**settings),
                           PS.PathTracerParams(), c2w, RES, seed, with_stats=True)
    assert ppt.ALPHA_RETRY_HOPS > hops  # rays reach the banners' cut-outs
    got = got.numpy()
    assert np.isfinite(got).all() and float(stats[1]) == 0.0
    _assert_images_match(got, want)


def test_courtyard_golden_ssim():
    from PIL import Image

    img, stats = render_courtyard_golden(device="cpu")
    golden = np.asarray(Image.open(GOLDEN))
    assert img.shape == golden.shape and img.dtype == np.uint8
    assert float(stats[1]) == 0.0
    assert ssim(img, golden) >= 0.99
