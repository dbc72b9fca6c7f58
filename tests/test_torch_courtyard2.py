"""courtyard2, the bench's 1.1M-triangle courtyard (density 2), in the port
against the JAX package, at the courtyard golden configuration's texture
size (64):

- the port's in-memory `courtyard_scene(density=2, tex_size=64)`, built by
  the port's flatten and scene build (`bench_scene.build_courtyard_probe`),
  gives the JAX package's build of `write_courtyard_glb(density=2,
  tex_size=64)` read by its loader (the port's BVH builder on both sides,
  tests/test_torch_scene.jax_knobs): world rows, compact material rows,
  wide BVH nodes, child meta words, leaf records and leaf words bit for
  bit, and the same scene meta but the JAX package's TPU leaf layout
  switch (leaf_hbm, set there as courtyard2's leaves exceed a TPU core's
  VMEM budget; the port has one layout). Its traversal stack bound, 31, lies within
  what K1's shared-memory stack takes (csrc/traverse.cu's SMEM_LIMIT /
  (THREADS x 4) + 1);
- the golden configuration's 128x72 window down the colonnade (2 bounces,
  alpha shadows, seed 1), traced by the port on its own tables, against
  the JAX package's trace on its tables, at the bar of
  tests/test_torch_pathtracer.py (at least 98% of pixels within atol 1e-4
  + rtol 1e-3, the mean within 1%), as tests/test_torch_courtyard.py holds
  the courtyard; the masked-retry loop runs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.render import pathtracer as jpt
from gltf_renderer_tpu.render import settings as JS
from gltf_renderer_tpu_torch.bench_scene import (
    COURTYARD_GOLDEN_RES,
    analytic_equirect,
    build_courtyard_probe,
)
from gltf_renderer_tpu_torch.ops import _build
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from tests.test_torch_alpha import both
from tests.test_torch_pathtracer import _assert_images_match
from tests.test_torch_scene import bits, jax_env

torch.set_num_threads(2)
TRIANGLES = 1096576


@pytest.fixture(scope="module")
def court2(tmp_path_factory):
    from gltf_renderer_tpu.scene.gltf import load_gltf
    from gltf_renderer_tpu.scene.procedural import write_courtyard_glb

    src = load_gltf(write_courtyard_glb(str(tmp_path_factory.mktemp("court2") / "c2.glb"),
                                        density=2, tex_size=64))
    out = both(src, env=jax_env(analytic_equirect(), 64))  # the port's default cube
    out["port"] = build_courtyard_probe(2, "cpu")
    return out


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(bits(a), bits(b))


def test_courtyard2_tables_equal_jax(court2):
    ps, pm, _, _, _, n_tris = court2["port"]
    js, jm = court2["jscene"], court2["jmeta"]
    assert n_tris == TRIANGLES
    for f in ps.world._fields:
        _eq(getattr(js.world, f), getattr(ps.world, f).numpy())
    _eq(js.materials.rows, ps.materials.rows.numpy())
    _eq(js.wide_nodes, ps.wide_nodes.numpy())
    _eq(js.wide_maps.meta, ps.wide_maps.meta.numpy())
    _eq(js.leaf_records, ps.leaf_records.numpy())
    _eq(js.leaf_words, ps.leaf_words.numpy())
    # leaf_hbm is the JAX package's TPU layout switch: courtyard2's leaves
    # exceed a TPU core's VMEM budget there (pallas_trace.py:541); the port
    # has one layout.
    assert jm.leaf_hbm == 1 and pm.leaf_hbm == 0
    for f in jm._fields:
        if f not in ("has_env", "leaf_hbm"):
            assert getattr(jm, f) == getattr(pm, f), f
    assert pm.has_masked and pm.stack_bound == 31
    k1_stack = (_build.source_define("traverse.cu", "SMEM_LIMIT")
                // (_build.source_define("traverse.cu", "THREADS") * 4) + 1)
    assert pm.stack_bound <= k1_stack


def test_courtyard2_window_matches_jax(court2):
    ps, pm, settings, params, c2w, _ = court2["port"]
    want = np.asarray(jax.jit(jpt.trace, static_argnums=(1, 2, 5))(
        court2["jscene"], court2["jmeta"],
        JS.PathTracerSettings(max_bounces=2, min_bounces=2, alpha_shadows=True),
        JS.PathTracerParams(), jnp.asarray(c2w), COURTYARD_GOLDEN_RES, jnp.uint32(1)))
    hops = ppt.ALPHA_RETRY_HOPS
    got, stats = ppt.trace(ps, pm, settings, params, c2w, COURTYARD_GOLDEN_RES, 1,
                           with_stats=True)
    assert ppt.ALPHA_RETRY_HOPS > hops  # rays reach the banners' cut-outs
    got = got.numpy()
    assert np.isfinite(got).all() and float(stats[1]) == 0.0
    _assert_images_match(got, want)
