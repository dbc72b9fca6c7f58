"""The port's alpha handling and punctual lights against the JAX package.

Scenes come from the JAX package's writers and loader; both packages trace
the same tables (`convert.from_jax_pt_scene`, with the port's native BVH build
on both sides, `tests/test_torch_scene.jax_knobs`).

- Foliage (`write_foliage_gltf`: an alpha-MASKed leaf between a point light
  and a floor), at the camera of `tests/test_materials.py::foliage`:
  `trace_closest` on the camera rays (hit ids identical except on lanes
  whose sampled base alpha lies within 1e-6 of the cutoff, counted);
  `trace_shadow(alpha_shadow=True)` toward the light (MASK: within 1e-6,
  the same cutoff exception; BLEND, where transmission is 1 - a bilinear
  texel blend: within 2e-5, the reference's fused multiply-adds moving the
  interpolated uv); the whole `trace` at 48x48 with the settings of
  `test_foliage_alpha_shadows`, alpha shadows on and off, with the leaf
  MASK and with it switched to BLEND.
- The port's `foliage_scene()` against the loader's tables, light table
  included, bit for bit.

Whole images meet the bar of tests/test_torch_pathtracer.py: at least 98%
of pixels within atol 1e-4 + rtol 1e-3, and the mean within 1%.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.render import pathtracer as jpt
from gltf_renderer_tpu.render import settings as JS
from gltf_renderer_tpu_torch import camera, convert
from gltf_renderer_tpu_torch.bench_scene import world_from_scene
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.render import settings as PS
from gltf_renderer_tpu_torch.scene.procedural import foliage_scene
from tests.test_torch_pathtracer import _assert_images_match
from tests.test_torch_scene import bits, jax_knobs

torch.set_num_threads(2)
RES = (48, 48)
CUTOFF_TIE = 1e-6


def foliage_camera(res):
    return camera.clip_to_world(camera.look_at([0.0, -4.0, 1.0], [0.0, 0.0, -0.5]),
                                y_fov=np.pi / 3, aspect=res[0] / res[1], z_near=0.01)


def jax_pt_scene(scene, env=None):
    """(JAX PTScene, PTMeta, world (numpy)) of a loaded Scene."""
    from gltf_renderer_tpu.scene import flatten as jf

    tf = jf.compute_global_transforms(scene)
    plan = jf.build_instance_plan(scene)
    world = jax.tree.map(np.asarray, jf.build_world_geometry(
        jax.tree.map(jnp.asarray, scene.pools), plan, jnp.asarray(tf),
        jnp.asarray(jf.normal_transforms(tf)), jf.plan_tri_flags(plan, scene.primitives)))
    lights = jf.gather_lights(scene, tf)
    jscene, jmeta = jpt.make_pt_scene(world, scene.materials, scene.textures, lights, env=env)
    return jscene, jmeta, world, lights


def both(scene, env=None):
    with pytest.MonkeyPatch.context() as mp:
        jax_knobs(mp)
        jscene, jmeta, world, lights = jax_pt_scene(scene, env)
    pscene, pmeta = convert.from_jax_pt_scene(jax.tree.map(np.asarray, jscene), jmeta, "cpu")
    return dict(jscene=jscene, jmeta=jmeta, pscene=pscene, pmeta=pmeta, world=world,
                lights=lights, src=scene)


def _blend_leaf(scene):
    """The foliage scene with the leaf material switched to BLEND."""
    from gltf_renderer_tpu.scene import types as JT

    mats = scene.materials
    mode = np.asarray(mats.alpha_mode).copy()
    mode[mode == JT.ALPHA_MODE_MASK] = JT.ALPHA_MODE_BLEND
    mats = mats._replace(alpha_mode=mode)
    return dataclasses.replace(scene, materials=mats._replace(rows=JT.pack_material_rows(mats)))


@pytest.fixture(scope="module")
def foliage(tmp_path_factory):
    from gltf_renderer_tpu.scene.gltf import load_gltf
    from gltf_renderer_tpu.scene.procedural import write_foliage_gltf

    src = load_gltf(write_foliage_gltf(str(tmp_path_factory.mktemp("fol") / "foliage.gltf")))
    return {"mask": both(src), "blend": both(_blend_leaf(src))}


@pytest.fixture(scope="module")
def jax_trace():
    return jax.jit(jpt.trace, static_argnums=(1, 2, 5))


def _camera_rays(res):
    """Pixel-centre camera rays of the foliage view, (origin, dir, t_max)."""
    w, h = res
    py, px = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    c2w = torch.as_tensor(foliage_camera(res))
    o, d = ppt.generate_camera_rays(px.reshape(-1), py.reshape(-1), res, c2w,
                                    torch.zeros(w * h, 2))
    t_max = torch.sqrt((d * d).sum(-1))
    return o, d / t_max[:, None], t_max


def _first_hit_alpha(s, o, d, t_max):
    """Sampled base alpha at each lane's first (unfiltered) closest hit."""
    first = ppt.closest_hit(s["pscene"], s["pmeta"], o, d, torch.zeros_like(t_max), t_max)
    alpha, _ = ppt._hit_base_alpha(s["pscene"], s["pmeta"], first.tri, first.u, first.v)
    return first, alpha


def test_foliage_scene_tables_equal_loader(foliage):
    s = foliage["mask"]
    j, p = s["src"], foliage_scene()
    for f in p.pools._fields:
        np.testing.assert_array_equal(bits(getattr(j.pools, f)), bits(getattr(p.pools, f)))
    np.testing.assert_array_equal(bits(j.materials.rows), bits(p.materials.rows))
    np.testing.assert_array_equal(bits(j.textures.rows), bits(p.textures.rows))
    np.testing.assert_array_equal(j.textures.atlas, p.textures.atlas)
    world, lights = world_from_scene(p)
    for f in world._fields:
        np.testing.assert_array_equal(bits(getattr(s["world"], f)), bits(getattr(world, f)))
    assert len(lights.type) == 1
    for f in lights._fields:
        np.testing.assert_array_equal(bits(getattr(s["lights"], f)), bits(getattr(lights, f)))


def test_foliage_trace_closest_matches_jax(foliage):
    s = foliage["mask"]
    assert s["pmeta"].has_masked and s["pmeta"].num_lights == 1
    o, d, t_max = _camera_rays(RES)
    t_min = torch.zeros_like(t_max)
    want = jax.jit(jpt.trace_closest, static_argnums=(1,))(
        s["jscene"], s["jmeta"], *(jnp.asarray(x.numpy()) for x in (o, d, t_min, t_max)))
    hops = ppt.ALPHA_RETRY_HOPS
    got = ppt.trace_closest(s["pscene"], s["pmeta"], o, d, t_min, t_max)
    assert ppt.ALPHA_RETRY_HOPS > hops
    first, alpha = _first_hit_alpha(s, o, d, t_max)
    rejected = (first.tri >= 0) & (alpha < 0.5) & (got.tri != first.tri)
    assert int(rejected.sum()) > 20  # rays through the leaf's holes reach the floor
    tie = (torch.abs(alpha - 0.5) <= CUTOFF_TIE) & (first.tri >= 0)
    differ = got.tri.numpy() != np.asarray(want.tri)
    assert not (differ & ~tie.numpy()).any()
    assert int(differ.sum()) <= int(tie.sum()) <= 2
    same = ~differ
    np.testing.assert_allclose(got.t.numpy()[same], np.asarray(want.t)[same], rtol=1e-6)


@pytest.mark.parametrize("mode", ["mask", "blend"])
def test_foliage_alpha_shadow_matches_jax(foliage, mode):
    s = foliage[mode]
    o, d, t_max = _camera_rays(RES)
    hit = ppt.trace_closest(s["pscene"], s["pmeta"], o, d, torch.zeros_like(t_max), t_max)
    attrs = ppt.fetch_hit_attributes(s["pscene"].world, hit.tri, hit.u, hit.v, d)
    org = ppt.offset_ray(attrs.position, attrs.geometric_normal)
    light = s["pscene"].lights.position[0]
    to_light = light - org
    dirs = to_light / torch.sqrt((to_light * to_light).sum(-1, keepdim=True))
    far = torch.full_like(t_max, 1000.0)
    active = hit.tri >= 0
    shadow = jax.jit(functools.partial(jpt.trace_shadow, alpha_shadow=True),
                     static_argnums=(1,))
    want = np.asarray(shadow(s["jscene"], s["jmeta"], jnp.asarray(org.numpy()),
                             jnp.asarray(dirs.numpy()), jnp.asarray(far.numpy()),
                             active=jnp.asarray(active.numpy())))
    hops = ppt.ALPHA_SHADOW_HOPS
    got = ppt.trace_shadow(s["pscene"], s["pmeta"], org, dirs, far, alpha_shadow=True,
                           active=active).numpy()
    assert ppt.ALPHA_SHADOW_HOPS > hops
    _, alpha = _first_hit_alpha(s, org, dirs, far)
    if mode == "mask":
        # Transmission is exactly 0 or 1: equal but for cutoff ties.
        tie = (torch.abs(alpha - 0.5) <= CUTOFF_TIE).numpy()
        off = np.abs(got - want) > 1e-6
        assert not (off & ~tie).any() and int(off.sum()) <= 2
    else:
        # 1 - alpha of a bilinear texel blend: the JAX reference's fused
        # multiply-adds move the interpolated uv, measured 7.6e-6 at most.
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    partial = (got > 0.0) & (got < 1.0)
    assert (partial.any() if mode == "blend" else not partial.any())
    assert (got == 0.0).sum() > 20 and (got == 1.0).sum() > 20  # shadowed and lit floor


def _foliage_settings(pkg, alpha_shadows):
    return pkg.PathTracerSettings(max_bounces=1, min_bounces=1, environment_map=False,
                                  luminance_clamp_enabled=False, alpha_shadows=alpha_shadows)


@pytest.mark.parametrize("mode", ["mask", "blend"])
@pytest.mark.parametrize("alpha_shadows", [True, False])
def test_foliage_trace_matches_jax(foliage, jax_trace, mode, alpha_shadows):
    s = foliage[mode]
    c2w = foliage_camera(RES)
    want = np.asarray(jax_trace(s["jscene"], s["jmeta"], _foliage_settings(JS, alpha_shadows),
                                JS.PathTracerParams(), jnp.asarray(c2w), RES, jnp.uint32(5)))
    hops = ppt.ALPHA_SHADOW_HOPS
    got, stats = ppt.trace(s["pscene"], s["pmeta"], _foliage_settings(PS, alpha_shadows),
                           PS.PathTracerParams(), c2w, RES, 5, with_stats=True)
    got = got.numpy()
    assert np.isfinite(got).all() and float(stats[1]) == 0.0
    # Alpha shadows run the hop loop; binary light shadows ride the merged launch.
    assert (ppt.ALPHA_SHADOW_HOPS > hops) == alpha_shadows
    _assert_images_match(got, want)
