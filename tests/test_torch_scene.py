"""Torch port scene and environment builders vs the JAX package.

On a small textured sphere and a 64x32 sky at cube size 32:
- the port's in-memory bench scene equals what the JAX glTF loader reads
  back from the GLB writer (pools, material/texture rows, atlas);
- world rows, BVH tables, wide maps, leaf words and compact material rows
  are exactly equal (both sides use the same native BVH builder);
- cube level 0 and each importance level agree to 1e-6 relative to the
  table's largest value (the builders evaluate atan2/sin/cos, whose last
  bits differ between XLA and torch, and a texel's bilinear weights scale
  that by the map size: measured 4.4e-6 relative on 0.015% of importance
  texels); the alias rows are built by the same host code from the
  importance map, so they are exactly equal when given the reference's map,
  and from the port's own map they sample the same distribution to the
  same 1e-6 of its largest probability.
"""

import os

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch.bench_scene import analytic_sky, world_from_scene
from gltf_renderer_tpu_torch.env.environment import build_environment_pt
from gltf_renderer_tpu_torch.ops import sampling as psampling
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.scene.procedural import textured_sphere_scene

torch.set_num_threads(2)


# Builders shared with test_torch_shading.py and test_torch_pathtracer.py.
# Both packages get the same small bench-style scene: a low-tessellation
# textured sphere (the bench's geometry kind and material), a 64x32 analytic
# sky at cube size 32, and the bench camera. The JAX side is built the way
# tools/make_goldens.py builds the fidelity golden: no quad atlas
# (GLTF_TPU_QUAD=0), f32 attribute rows (GLTF_TPU_BF16ROWS=0), f32 cube
# tables (GLTF_TPU_QUADF32=1), and no environment disk cache. Its environment
# tables come from the JAX builders the path tracer reads (cube level 0, the
# importance pyramid and the alias rows); the raster-only GGX and diffuse
# prefilters are skipped.

SPHERE = dict(tex_size=64, n_lat=12, n_lon=24, metallic=0.3, roughness=0.45)
SKY_HW = (32, 64)
CUBE_SIZE = 32
DIFFUSE_SIZE = 8  # the raster-only diffuse cube, small: the path tracer never reads it
JAX_KNOBS = {
    "GLTF_TPU_QUAD": "0",
    "GLTF_TPU_BF16ROWS": "0",
    "GLTF_TPU_QUADF32": "1",
    "GLTF_TPU_ENV_CACHE": "off",
}


def jax_knobs(mp: pytest.MonkeyPatch) -> None:
    """Golden-config JAX table knobs, and the port's BVH builder on both
    sides so the trees are the same."""
    from gltf_renderer_tpu.ops import bvh as jax_bvh
    from gltf_renderer_tpu_torch.ops import bvh as port_bvh

    for k, v in JAX_KNOBS.items():
        mp.setenv(k, v)
    mp.setattr(jax_bvh, "_NATIVE", port_bvh._load_native())
    mp.setattr(jax_bvh, "_NATIVE_TRIED", True)


def jax_env(sky, cube=CUBE_SIZE):
    """JAX EnvMaps holding what the path tracer reads (the cube pyramid at
    `cube`, the importance map and the alias rows)."""
    import jax.numpy as jnp

    from gltf_renderer_tpu.env import environment as E
    from gltf_renderer_tpu.ops import sampling as Sm

    cube_mips = E.build_cube_mips(E.build_cubemap(jnp.asarray(sky), cube))
    importance = E.build_importance_map(cube_mips[0], cube_mips[1:])
    alias = Sm.build_alias_rows(np.asarray(importance[0]))
    return E.EnvMaps(cube=cube_mips, ggx=[], diffuse=None, importance=importance,
                     equirect=jnp.asarray(sky), alias_rows=jnp.asarray(alias))


def build_jax_bench_scene(tmp_dir):
    """(loaded Scene, world (numpy leaves), PTScene, PTMeta) of the small
    bench-style scene, built by the JAX package."""
    import jax
    import jax.numpy as jnp

    from gltf_renderer_tpu.render import pathtracer as jpt
    from gltf_renderer_tpu.scene import flatten as jf
    from gltf_renderer_tpu.scene.gltf import load_gltf
    from gltf_renderer_tpu.scene.procedural import write_textured_sphere_glb
    from gltf_renderer_tpu_torch.bench_scene import analytic_sky

    scene = load_gltf(write_textured_sphere_glb(os.path.join(tmp_dir, "sphere.glb"), **SPHERE))
    tf = jf.compute_global_transforms(scene)
    plan = jf.build_instance_plan(scene)
    world = jax.tree.map(np.asarray, jf.build_world_geometry(
        jax.tree.map(jnp.asarray, scene.pools), plan, jnp.asarray(tf),
        jnp.asarray(jf.normal_transforms(tf)), jf.plan_tri_flags(plan, scene.primitives)))
    ptscene, meta = jpt.make_pt_scene(world, scene.materials, scene.textures,
                                      jf.gather_lights(scene, tf), env=jax_env(analytic_sky(*SKY_HW)))
    return scene, world, ptscene, meta


def jax_settings():
    from gltf_renderer_tpu.render import settings as JS

    return JS.PathTracerSettings(max_bounces=2, min_bounces=2, alpha_shadows=False), \
        JS.PathTracerParams()


def port_settings():
    from gltf_renderer_tpu_torch.render import settings as PS

    return PS.PathTracerSettings(max_bounces=2, min_bounces=2, alpha_shadows=False), \
        PS.PathTracerParams()


def bits(a):
    """View f32 arrays as i32 so tables holding bitcast ids compare exactly."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        jax_knobs(mp)
        jscene_src, jworld, jscene, jmeta = build_jax_bench_scene(
            str(tmp_path_factory.mktemp("scene")))
    scene = textured_sphere_scene(**SPHERE)
    world, lights = world_from_scene(scene)
    env = build_environment_pt(analytic_sky(*SKY_HW), cube_size=CUBE_SIZE, device="cpu",
                               diffuse_size=DIFFUSE_SIZE)
    pscene, pmeta = ppt.make_pt_scene(world, scene.materials, scene.textures, lights, env=env,
                                      device="cpu")
    return dict(jsrc=jscene_src, jworld=jworld, jscene=jscene, jmeta=jmeta, src=scene,
                world=world, scene=pscene, meta=pmeta)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(bits(a), bits(b))


def test_procedural_scene_equals_loaded_glb(built):
    j, p = built["jsrc"], built["src"]
    for f in p.pools._fields:
        _eq(getattr(j.pools, f), getattr(p.pools, f))
    for f in p.primitives._fields:
        _eq(getattr(j.primitives, f), getattr(p.primitives, f))
    _eq(j.materials.rows, p.materials.rows)
    _eq(j.textures.rows, p.textures.rows)
    _eq(j.textures.atlas, p.textures.atlas)


def test_world_rows_exact(built):
    for f in built["world"]._fields:
        _eq(getattr(built["jworld"], f), getattr(built["world"], f))


def test_bvh_and_traversal_tables_exact(built):
    js, ps = built["jscene"], built["scene"]
    _eq(js.bvh.tri_order, ps.bvh.tri_order)
    for f in ("nodes", "records", "words"):
        _eq(getattr(js.packed, f), getattr(ps.packed, f))
    _eq(js.wide_maps.child_src, ps.wide_maps.child_src)
    _eq(js.wide_maps.meta, ps.wide_maps.meta.numpy())
    _eq(js.wide_maps.leaf_ids, ps.wide_maps.leaf_ids)
    _eq(js.wide_nodes, ps.wide_nodes.numpy())
    _eq(js.leaf_records, ps.leaf_records.numpy())
    _eq(js.leaf_words, ps.leaf_words.numpy())
    jm, pm = built["jmeta"], built["meta"]
    for f in jm._fields:
        assert getattr(jm, f) == getattr(pm, f), f
    assert pm.stack_bound >= 4


def test_material_rows_and_atlas_exact(built):
    js, ps = built["jscene"], built["scene"]
    _eq(js.materials.rows, ps.materials.rows.numpy())
    _eq(js.textures.atlas_linear, ps.textures.atlas_linear.numpy())
    _eq(js.textures.rows, ps.textures.rows.numpy())


def _close(a, b, rel=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), np.abs(a - b).max() / np.abs(b).max()


def _implied_distribution(rows):
    """Texel probabilities a Walker alias table samples."""
    n = rows.shape[0]
    keep = rows[:, 0].astype(np.float64)
    alias = rows[:, 1].view(np.int32)
    return (keep + np.bincount(alias, weights=1.0 - keep, minlength=n)) / n


def test_environment_tables(built):
    jenv, penv = built["jscene"].env, built["scene"].env
    _close(penv.cube[0].numpy(), jenv.cube[0])
    assert len(penv.importance) == len(jenv.importance)
    for a, b in zip(penv.importance, jenv.importance):
        _close(a.numpy(), b)
    # Same host construction: identical rows from the same importance map.
    _eq(psampling.build_alias_rows(np.asarray(jenv.importance[0])), jenv.alias_rows)
    # From the port's own map: the same distribution.
    p_port = _implied_distribution(penv.alias_rows.numpy())
    p_ref = _implied_distribution(np.asarray(jenv.alias_rows))
    _close(p_port, p_ref)
    _close(penv.alias_rows.numpy()[:, 2], np.asarray(jenv.alias_rows)[:, 2])
