"""Torch port raster shading inputs vs the JAX package.

- The environment prefilters: `_filter_cube_level` at a small size and
  sample count, for the GGX and the cosine lobes, on the same source cube
  mips. They agree to 2e-5 relative to the cube's largest value: each output
  texel is a weighted sum of trilinear cube fetches whose level comes from a
  log2 and whose directions go through sin/cos, and those last bits differ
  between XLA and torch.
- The texture mip pyramid (`build_atlas_mips`): bit-equal, on the bench-style
  atlas and on an NPOT pair (13x7 with REPEAT and 8x5 with CLAMP).
- Hit attributes with the raster back-face convention and the footprint
  (`fetch_hit_attributes(raster_flip=True, with_footprint=True)`), on the
  same fixed hits: 1e-5 relative plus 1e-6 absolute, ids exactly.
- `shade_forward` on the same fixed hits and footprints, both packages
  reading the same tables (convert.from_jax_pt_scene): 1e-4 relative plus
  1e-5 absolute. The mip level is mip_base + log2 terms, and the IBL's DFG
  term is a pow of 2; their last bits move the trilinear weights slightly.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu_torch import convert
from gltf_renderer_tpu_torch.env import environment as penv
from gltf_renderer_tpu_torch.ops import texture as ptex
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.render import rasterizer as prz

torch.set_num_threads(2)

RASTER_SPHERE = dict(metallic=0.4, roughness=0.35)  # golden helmet_raster material
ENV_CUBE = 32
DIFFUSE_SIZE, DIFFUSE_SAMPLES = 8, 64
RASTER_KNOBS = {
    "GLTF_TPU_QUAD": "0",
    "GLTF_TPU_QUADMIPS": "0",
    "GLTF_TPU_QUADCUBE": "0",
    "GLTF_TPU_BF16ROWS": "0",
    "GLTF_TPU_QUADF32": "1",
    "GLTF_TPU_ENV_CACHE": "off",
}


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_raster_env(equirect):
    """JAX EnvMaps with the raster IBL cubes: the GGX pyramid from the JAX
    builder, the diffuse cube at a small size (the packages run the same
    filter; the size only needs to match)."""
    from gltf_renderer_tpu.env import environment as E
    from gltf_renderer_tpu.ops import sampling as Sm

    cube_mips = E.build_cube_mips(E.build_cubemap(jnp.asarray(equirect), ENV_CUBE))
    importance = E.build_importance_map(cube_mips[0], cube_mips[1:])
    return E.EnvMaps(
        cube=cube_mips, ggx=E.build_ggx_cube(cube_mips),
        diffuse=E._filter_cube_level(cube_mips, DIFFUSE_SIZE, jnp.float32(1.0), DIFFUSE_SAMPLES,
                                     E.DIFFUSE_MIP_BIAS, False),
        importance=importance, equirect=jnp.asarray(equirect),
        alias_rows=jnp.asarray(Sm.build_alias_rows(np.asarray(importance[0]))))


def build_jax_raster_scene(tmp_dir):
    """(JAX PTScene, PTMeta, port PTScene, PTMeta) of the helmet-raster
    configuration's scene (small textured sphere, the 32x64 analytic
    environment), built by the JAX package with its mip pyramid and the
    port's BVH builder, and carried across."""
    from gltf_renderer_tpu.ops import bvh as jax_bvh
    from gltf_renderer_tpu.render import pathtracer as jpt
    from gltf_renderer_tpu.scene import flatten as jf
    from gltf_renderer_tpu.scene.gltf import load_gltf
    from gltf_renderer_tpu.scene.procedural import write_textured_sphere_glb
    from gltf_renderer_tpu_torch.bench_scene import analytic_equirect
    from gltf_renderer_tpu_torch.ops import bvh as port_bvh

    with pytest.MonkeyPatch.context() as mp:
        for k, v in RASTER_KNOBS.items():
            mp.setenv(k, v)
        mp.setattr(jax_bvh, "_NATIVE", port_bvh._load_native())
        mp.setattr(jax_bvh, "_NATIVE_TRIED", True)
        scene = load_gltf(write_textured_sphere_glb(os.path.join(tmp_dir, "sphere.glb"),
                                                    **RASTER_SPHERE))
        tf = jf.compute_global_transforms(scene)
        plan = jf.build_instance_plan(scene)
        world = jax.tree.map(np.asarray, jf.build_world_geometry(
            jax.tree.map(jnp.asarray, scene.pools), plan, jnp.asarray(tf),
            jnp.asarray(jf.normal_transforms(tf)), jf.plan_tri_flags(plan, scene.primitives)))
        jscene, jmeta = jpt.make_pt_scene(world, scene.materials, scene.textures,
                                          jf.gather_lights(scene, tf),
                                          env=jax_raster_env(analytic_equirect()))
    assert jscene.textures.mip_flat is not None and jscene.textures.mip_quad is None
    pscene, pmeta = convert.from_jax_pt_scene(jax.tree.map(np.asarray, jscene), jmeta, "cpu")
    return jscene, jmeta, pscene, pmeta


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return build_jax_raster_scene(str(tmp_path_factory.mktemp("raster")))


@pytest.mark.parametrize("ggx", [True, False], ids=["ggx", "diffuse"])
def test_filter_cube_level_matches_jax(ggx):
    from gltf_renderer_tpu.env import environment as E
    from gltf_renderer_tpu_torch.bench_scene import analytic_sky

    sky = analytic_sky(32, 64)
    jmips = E.build_cube_mips(E.build_cubemap(jnp.asarray(sky), 16))
    pmips = [_t(np.asarray(m)) for m in jmips]
    a, samples, bias = (0.25, 16, E.GGX_MIP_BIAS) if ggx else (1.0, 32, E.DIFFUSE_MIP_BIAS)
    want = np.asarray(E._filter_cube_level(jmips, 8, jnp.float32(a), samples, bias, ggx))
    got = penv._filter_cube_level(pmips, 8, a, samples, bias, ggx).numpy()
    assert got.shape == (6, 8, 8, 3)
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max(), np.abs(got - want).max()


def test_prefiltered_pyramid_layout():
    cube_mips = penv.build_cube_mips(torch.rand(6, 32, 32, 3))
    ggx = penv.build_ggx_cube(cube_mips, num_samples=4)
    assert [m.shape[1] for m in ggx] == [32, 16]  # log2(32) + 1 - GGX_SMALLEST_MIP levels
    assert ggx[0] is cube_mips[0]
    assert penv.build_diffuse_cube(cube_mips, size=4, num_samples=4).shape == (6, 4, 4, 3)


def _npot_textures(table_cls):
    rs = np.random.default_rng(5)
    atlas = rs.integers(0, 256, (16, 24, 4), dtype=np.uint8)
    return table_cls(
        atlas=atlas, x=np.asarray([0, 13], np.int32), y=np.asarray([0, 3], np.int32),
        width=np.asarray([13, 8], np.int32), height=np.asarray([7, 5], np.int32),
        wrap_s=np.asarray([0, 1], np.int32), wrap_t=np.asarray([0, 1], np.int32),
        nearest=np.zeros(2, np.int32), srgb=np.asarray([1, 0], np.int32))


def test_build_atlas_mips_bit_equal(scenes):
    from gltf_renderer_tpu.ops import texture as jtex
    from gltf_renderer_tpu.scene import types as JT
    from gltf_renderer_tpu_torch.scene import types as PT

    jscene, _, pscene, _ = scenes
    np.testing.assert_array_equal(pscene.textures.mip_flat.numpy().view(np.int16),
                                  np.asarray(jscene.textures.mip_flat).view(np.int16))
    np.testing.assert_array_equal(pscene.textures.mip_rows.numpy().view(np.int32),
                                  np.asarray(jscene.textures.mip_rows).view(np.int32))
    want = jtex.build_atlas_mips(jtex.decode_atlas_linear(_npot_textures(JT.TextureTable)))
    got = ptex.build_atlas_mips(ptex.decode_atlas_linear(_npot_textures(PT.TextureTable)))
    assert got.mip_flat.dtype == np.float16
    np.testing.assert_array_equal(got.mip_flat.view(np.int16), want.mip_flat.view(np.int16))
    np.testing.assert_array_equal(got.mip_rows.view(np.int32), want.mip_rows.view(np.int32))


def test_port_scene_build_has_the_pyramid(scenes):
    """The port's own make_pt_scene builds the same pyramid as the JAX one."""
    from gltf_renderer_tpu_torch.bench_scene import world_from_scene
    from gltf_renderer_tpu_torch.scene.procedural import textured_sphere_scene

    jscene = scenes[0]
    scene = textured_sphere_scene(**RASTER_SPHERE)
    world, lights = world_from_scene(scene)
    pscene, _ = ppt.make_pt_scene(world, scene.materials, scene.textures, lights, device="cpu")
    np.testing.assert_array_equal(pscene.textures.mip_flat.numpy().view(np.int16),
                                  np.asarray(jscene.textures.mip_flat).view(np.int16))


def _hits(jscene, n=512, seed=0):
    """Fixed hits on triangles a ray can hit (the sphere's pole triangles
    have zero area), random directions (so back faces occur), hit
    distances and world footprints."""
    rs = np.random.default_rng(seed)
    pos = np.asarray(jscene.world.position)
    tv = np.asarray(jscene.world.tri_vertex)
    e1 = pos[tv[:, 1]] - pos[tv[:, 0]]
    e2 = pos[tv[:, 2]] - pos[tv[:, 0]]
    area = np.linalg.norm(np.cross(e1, e2), axis=-1)
    scale = np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1)
    tri = rs.choice(np.nonzero(area > 1e-3 * scale)[0], n).astype(np.int32)
    uv = rs.random((n, 2)).astype(np.float32)
    flip = uv.sum(-1) > 1.0
    uv[flip] = 1.0 - uv[flip]
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rs.uniform(0.5, 3.0, n).astype(np.float32)
    mip_scale = np.exp(rs.uniform(np.log(1e-4), np.log(1e-1), n)).astype(np.float32)
    return tri, uv[:, 0].copy(), uv[:, 1].copy(), d, t, mip_scale


def test_fetch_hit_attributes_raster(scenes):
    from gltf_renderer_tpu.render import pathtracer as jpt

    jscene, _, pscene, _ = scenes
    tri, u, v, d, _, _ = _hits(jscene)
    want = jpt.fetch_hit_attributes(jscene.world, jnp.asarray(tri), jnp.asarray(u),
                                    jnp.asarray(v), jnp.asarray(d), with_footprint=True,
                                    raster_flip=True)
    got = ppt.fetch_hit_attributes(pscene.world, _t(tri).long(), _t(u), _t(v), _t(d),
                                   with_footprint=True, raster_flip=True)
    assert got.back_face.numpy().any() and not got.back_face.numpy().all()
    for f in got._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_shade_forward_matches_jax(scenes):
    from gltf_renderer_tpu.ops import bvh as jbvh
    from gltf_renderer_tpu.render import rasterizer as jrz

    jscene, jmeta, pscene, pmeta = scenes
    tri, u, v, d, t, mip_scale = _hits(jscene, seed=1)
    jhit = jbvh.Hit(t=jnp.asarray(t), tri=jnp.asarray(tri), u=jnp.asarray(u), v=jnp.asarray(v))
    origin = jnp.asarray(-d * t[:, None])
    want = jrz.shade_forward(jscene, jmeta, jhit, origin, jnp.asarray(d), jnp.zeros(3), 1.0,
                             jnp.zeros((tri.shape[0], 2)), use_env=True,
                             mip_scale=jnp.asarray(mip_scale))
    phit = ppt.Hit(t=_t(t), tri=_t(tri).long(), u=_t(u), v=_t(v))
    got = prz.shade_forward(pscene, pmeta, phit, _t(np.asarray(origin)), _t(d), torch.zeros(3),
                            1.0, None, use_env=True, mip_scale=_t(mip_scale))
    rgb = got[0].numpy()
    assert np.isfinite(rgb).all() and rgb.max() > 0.05
    np.testing.assert_allclose(rgb, np.asarray(want[0]), rtol=1e-4, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Level 0 and the pyramid differ: the footprint reaches the mips.
    lvl0 = prz.shade_forward(pscene, pmeta, phit, _t(np.asarray(origin)), _t(d), torch.zeros(3),
                             1.0, None, use_env=True)[0].numpy()
    assert np.abs(lvl0 - rgb).max() > 1e-3


@pytest.mark.parametrize("mips", [False, True], ids=["level0", "mips"])
def test_texture_fetch_casts_huge_uv_as_xla(scenes, mips):
    """Texel coordinates at or beyond 2^31 (uv of +-3e8) are cast as XLA
    casts them, saturating to int32, and the +1 corner wraps in int32, so
    both texture paths fetch the reference's texels; torch's own cast
    would not saturate and fetched other texels."""
    from gltf_renderer_tpu.ops import material as jmat
    from gltf_renderer_tpu.render import pathtracer as jpt
    from gltf_renderer_tpu_torch.ops import material as pmat

    jscene, jmeta, pscene, pmeta = scenes
    tri, u, v, d, _, mip_scale = _hits(jscene, n=64, seed=4)
    attrs = jpt.fetch_hit_attributes(jscene.world, jnp.asarray(tri), jnp.asarray(u),
                                     jnp.asarray(v), jnp.asarray(d))
    uv0 = np.asarray(attrs.uv0).copy()
    uv0[:16], uv0[16:32] = 3e8, -3e8
    mip_base = np.log2(mip_scale) if mips else None
    args = [attrs.material, uv0, attrs.uv1, attrs.color, attrs.normal, attrs.tangent,
            attrs.bitangent, attrs.geometric_normal, -d]
    want, _ = jmat.get_surface_properties(
        jscene.materials, jscene.textures, *map(jnp.asarray, args),
        used_slots=jmeta.used_slots, rows_compact=True, identity_uv=jmeta.identity_uv,
        wrap_modes=jmeta.wrap_modes, any_nearest=jmeta.any_nearest,
        mip_base=None if mip_base is None else jnp.asarray(mip_base))
    got, _ = pmat.get_surface_properties(
        pscene.materials, pscene.textures, *[_t(np.asarray(a)) for a in args],
        used_slots=pmeta.used_slots, identity_uv=pmeta.identity_uv,
        wrap_modes=pmeta.wrap_modes, any_nearest=pmeta.any_nearest,
        mip_base=None if mip_base is None else _t(mip_base))
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
