"""The material zoo in the port against the JAX package.

`write_materials_gltf` read by the JAX loader (four UV spheres: thin
transmission with volume attenuation and ior, clearcoat, sheen,
anisotropic metal; an emissive floor), both packages on the same tables
(`convert.from_jax_pt_scene`, the port's native BVH build on both sides):
- the port's in-memory `materials_scene()` gives the loader's pools,
  primitives, material table (KHR factors, anisotropy, rows) and empty
  texture table, and through the port's flatten and scene build the same
  world rows (tri_alpha_mode included), BVH tables, compact material rows,
  meta flags and Sheen_E LUT, bit for bit;
- on 510 fixed hits, 102 on each material: `get_surface_properties` (the
  clearcoat, sheen, transmission and thickness fields non-zero where the
  material has them), then on the JAX surface `layer_probabilities`,
  `bsdf_pdf`, `evaluate_bsdf` and `sample_bsdf` in the MIS, diffuse-white
  and non-MIS modes, at the shading tests' bars (tests/test_torch_shading.py:
  1e-5 relative + 1e-6 absolute; sample_bsdf's bsdf and pdf at the
  direction it sampled 1e-4, its sin/cos differing in the last bits);
- `trace` at 48x36 with 2 bounces in the three modes, at the bar of
  tests/test_torch_pathtracer.py (at least 98% of pixels within atol 1e-4
  + rtol 1e-3, the mean within 1%).

Port only: the materials golden configuration through the port's Renderer
(`render_materials_golden`, the port's zoo file, 160x120, eight frames) against tests/goldens/materials_pt.png at the SSIM
bar of tests/test_ssim_baseline.py (0.99), and the layer furnace of
tests/test_pathtracer.py::test_pt_layer_furnace_no_energy_gain (a white box
in a uniform 0.5 environment, 5 bounces, 16 frames: the centre's mean
within [0.5 x 0.55, 0.5 x 1.08]) with each layer on in the material rows
the tracer reads.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.ops import material as jmat
from gltf_renderer_tpu.render import pathtracer as jpt
from gltf_renderer_tpu.render import settings as JS
from gltf_renderer_tpu_torch import camera
from gltf_renderer_tpu_torch.bench_scene import (
    analytic_equirect,
    materials_camera,
    render_materials_golden,
    world_from_scene,
)
from gltf_renderer_tpu_torch.ops import material as pmat
from gltf_renderer_tpu_torch.ops.bsdf import SurfaceProperties
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.render import settings as PS
from gltf_renderer_tpu_torch.scene import types as PT
from gltf_renderer_tpu_torch.scene.procedural import materials_scene
from gltf_renderer_tpu_torch.utils.ssim import ssim
from tests.test_torch_alpha import both
from tests.test_torch_pathtracer import _assert_images_match
from tests.test_torch_scene import bits, jax_env

torch.set_num_threads(2)
RES = (48, 36)
PER_MATERIAL = 102
RTOL, ATOL = 1e-5, 1e-6
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "materials_pt.png")
MODES = {"mis": {}, "diffuse_white": dict(material_diffuse_white=True),
         "no_mis": dict(material_mis=False)}


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    from gltf_renderer_tpu.scene.gltf import load_gltf
    from gltf_renderer_tpu.scene.procedural import write_materials_gltf

    src = load_gltf(write_materials_gltf(str(tmp_path_factory.mktemp("zoo") / "zoo.gltf")))
    return both(src, env=jax_env(analytic_equirect()))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(bits(a), bits(b))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL)


def test_materials_scene_tables_equal_loader(zoo):
    j, p = zoo["src"], materials_scene()
    for f in p.pools._fields:
        _eq(getattr(j.pools, f), getattr(p.pools, f))
    for f in p.primitives._fields:
        _eq(getattr(j.primitives, f), getattr(p.primitives, f))
    for f in p.materials._fields:
        _eq(getattr(j.materials, f), getattr(p.materials, f))
    for f in ("rows", "atlas", "x", "width"):
        _eq(getattr(j.textures, f), getattr(p.textures, f))
    _eq(j.topo_order, p.topo_order)
    world, lights = world_from_scene(p)
    assert world.tri_vertex.shape[0] == 4 * 2208 + 2 and len(lights.type) == 0
    for f in world._fields:
        _eq(getattr(zoo["world"], f), getattr(world, f))
    assert (np.asarray(world.tri_alpha_mode) == PT.ALPHA_MODE_OPAQUE).all()
    ps, pm = ppt.make_pt_scene(world, p.materials, p.textures, lights, device="cpu")
    js, jm = zoo["jscene"], zoo["jmeta"]
    _eq(js.materials.rows, ps.materials.rows.numpy())
    _eq(js.wide_nodes, ps.wide_nodes.numpy())
    _eq(js.leaf_records, ps.leaf_records.numpy())
    _eq(js.leaf_words, ps.leaf_words.numpy())
    _eq(js.sheen_table, ps.sheen_table.numpy())
    _eq(js.sheen_table, zoo["pscene"].sheen_table.numpy())
    for f in jm._fields:
        if f != "has_env":
            assert getattr(jm, f) == getattr(pm, f), f
    # The transmissive sphere's triangles are BLEND-flagged for traversal.
    assert pm.has_sheen and pm.has_clearcoat and pm.has_transmission and pm.has_blend
    assert not pm.has_alpha_layer


def _hits(jscene):
    """PER_MATERIAL fixed hits on each material's hittable triangles (the
    spheres' pole triangles have zero area), with random view directions."""
    rs = np.random.default_rng(0)
    pos = np.asarray(jscene.world.position)
    tv = np.asarray(jscene.world.tri_vertex)
    e1 = pos[tv[:, 1]] - pos[tv[:, 0]]
    e2 = pos[tv[:, 2]] - pos[tv[:, 0]]
    area = np.linalg.norm(np.cross(e1, e2), axis=-1)
    hittable = area > 1e-3 * np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1)
    mat = np.asarray(jscene.world.tri_material)
    tri = np.concatenate([rs.choice(np.nonzero(hittable & (mat == m))[0], PER_MATERIAL)
                          for m in range(1, 6)]).astype(np.int32)
    n = tri.shape[0]
    uv = rs.random((n, 2)).astype(np.float32)
    flip = uv.sum(-1) > 1.0
    uv[flip] = 1.0 - uv[flip]
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tri, uv[:, 0].copy(), uv[:, 1].copy(), d


@pytest.fixture(scope="module")
def shading(zoo):
    """JAX hit attributes and surface on the fixed hits, and the port's
    surface from the same attributes."""
    jscene, jmeta, pscene, pmeta = zoo["jscene"], zoo["jmeta"], zoo["pscene"], zoo["pmeta"]
    tri, u, v, d = _hits(jscene)
    attrs = jpt.fetch_hit_attributes(jscene.world, jnp.asarray(tri), jnp.asarray(u),
                                     jnp.asarray(v), jnp.asarray(d))
    want = jmat.get_surface_properties(
        jscene.materials, jscene.textures, attrs.material, attrs.uv0, attrs.uv1, attrs.color,
        attrs.normal, attrs.tangent, attrs.bitangent, attrs.geometric_normal, -jnp.asarray(d),
        used_slots=jmeta.used_slots, rows_compact=True, identity_uv=jmeta.identity_uv,
        wrap_modes=jmeta.wrap_modes, any_nearest=jmeta.any_nearest)
    got = pmat.get_surface_properties(
        pscene.materials, pscene.textures, _t(attrs.material), _t(attrs.uv0), _t(attrs.uv1),
        _t(attrs.color), _t(attrs.normal), _t(attrs.tangent), _t(attrs.bitangent),
        _t(attrs.geometric_normal), -_t(d), used_slots=pmeta.used_slots,
        identity_uv=pmeta.identity_uv, wrap_modes=pmeta.wrap_modes,
        any_nearest=pmeta.any_nearest)
    return dict(attrs=attrs, d=d, want=want, got=got,
                port_sp=SurfaceProperties(*[_t(x) for x in want[0]]))


def test_zoo_surface_properties(shading):
    want_sp, want_ex = shading["want"]
    got_sp, got_ex = shading["got"]
    for f in SurfaceProperties._fields:
        _close(getattr(got_sp, f), getattr(want_sp, f))
    for f in got_ex._fields:
        _close(getattr(got_ex, f), getattr(want_ex, f))
    # Each layer is present on its sphere and nowhere else.
    k = PER_MATERIAL
    for field, row in (("transmissive", 0), ("thickness", 0), ("clearcoat", 1),
                       ("sheen_color", 2)):
        x = np.abs(np.asarray(getattr(want_sp, field))).max(-1)
        assert (x[row * k:(row + 1) * k] > 0).all() and (np.delete(x, np.s_[row * k:(row + 1) * k]) == 0).all(), field
    assert (np.asarray(want_ex.emissive)[4 * k:] > 0).all()


def _modes(mode, **kw):
    return (JS.PathTracerSettings(**MODES[mode], **kw),
            PS.PathTracerSettings(**MODES[mode], **kw))


def test_zoo_layer_probabilities_and_pdf(zoo, shading):
    jmeta, pmeta = zoo["jmeta"], zoo["pmeta"]
    want_sp = shading["want"][0]
    sp = shading["port_sp"]
    rs = np.random.default_rng(1)
    l = rs.normal(size=(sp.alpha.shape[0], 3)).astype(np.float32)
    l /= np.linalg.norm(l, axis=-1, keepdims=True)
    v = -shading["d"]
    probs_j = jpt.layer_probabilities(want_sp, jnp.asarray(v), jmeta)
    probs_p = ppt.layer_probabilities(sp, _t(v), pmeta)
    for g, w in zip(probs_p, probs_j):
        _close(g, w)
    assert all((np.asarray(p) > 0).any() for p in probs_j[1:])  # every layer but alpha
    is_t = rs.random(sp.alpha.shape[0]) < 0.5
    _close(ppt.bsdf_pdf(sp, _t(v), _t(l), _t(is_t), probs_p, pmeta),
           jpt.bsdf_pdf(want_sp, jnp.asarray(v), jnp.asarray(l), jnp.asarray(is_t), probs_j,
                        jmeta))


@pytest.mark.parametrize("mode", list(MODES))
def test_zoo_evaluate_bsdf(zoo, shading, mode):
    jset, pset = _modes(mode)
    attrs, d = shading["attrs"], shading["d"]
    l = np.random.default_rng(2).normal(size=d.shape).astype(np.float32)
    l /= np.linalg.norm(l, axis=-1, keepdims=True)
    f, pdf = jpt.evaluate_bsdf(shading["want"][0], attrs.geometric_normal, -jnp.asarray(d),
                               jnp.asarray(l), jset, zoo["jscene"].sheen_table,
                               meta=zoo["jmeta"])
    gf, gpdf = ppt.evaluate_bsdf(shading["port_sp"], _t(attrs.geometric_normal), -_t(d), _t(l),
                                 pset, zoo["pmeta"], zoo["pscene"].sheen_table)
    _close(gf, f)
    _close(gpdf, pdf)
    assert (np.asarray(f) > 0).any()


@pytest.mark.parametrize("mode", list(MODES))
def test_zoo_sample_bsdf(zoo, shading, mode):
    jset, pset = _modes(mode)
    d = shading["d"]
    u3 = np.random.default_rng(3).random((d.shape[0], 3)).astype(np.float32)
    want = jpt.sample_bsdf(shading["want"][0], jnp.asarray(u3), -jnp.asarray(d), jset,
                           zoo["jscene"].sheen_table, meta=zoo["jmeta"])
    f, l, pdf, is_t, use_mis = ppt.sample_bsdf(shading["port_sp"], _t(u3), -_t(d), pset,
                                               zoo["pmeta"], zoo["pscene"].sheen_table)
    _close(l, want[1])
    _close(is_t, want[3])
    _close(use_mis, want[4])
    _close(f, want[0], rtol=1e-4)
    _close(pdf, want[2], rtol=1e-4)
    if mode == "mis":  # the thin-transmission lobe is sampled
        assert np.asarray(want[3]).any()


@pytest.fixture(scope="module")
def jax_trace():
    return jax.jit(jpt.trace, static_argnums=(1, 2, 5))


@pytest.mark.parametrize("mode", list(MODES))
def test_zoo_trace_matches_jax(zoo, jax_trace, mode):
    jset, pset = _modes(mode, max_bounces=2, min_bounces=2)
    c2w = materials_camera(*RES)
    want = np.asarray(jax_trace(zoo["jscene"], zoo["jmeta"], jset, JS.PathTracerParams(),
                                jnp.asarray(c2w), RES, jnp.uint32(3)))
    got, stats = ppt.trace(zoo["pscene"], zoo["pmeta"], pset, PS.PathTracerParams(), c2w, RES, 3,
                           with_stats=True)
    got = got.numpy()
    assert np.isfinite(got).all() and float(stats[1]) == 0.0
    _assert_images_match(got, want)


def test_materials_golden_ssim():
    from PIL import Image

    img, stats = render_materials_golden(device="cpu")
    golden = np.asarray(Image.open(GOLDEN))
    assert img.shape == golden.shape and img.dtype == np.uint8
    assert float(stats[1]) == 0.0
    assert ssim(img, golden) >= 0.99


def _furnace_box(layer):
    """The white box of the JAX furnace test (write_box_gltf, roughness
    0.5, no light) read by the JAX loader, with one layer set in the
    material table and its rows repacked, so the tracer shades with it."""
    import tempfile

    from gltf_renderer_tpu.scene.gltf import load_gltf
    from gltf_renderer_tpu.scene.procedural import write_box_gltf

    path = write_box_gltf(os.path.join(tempfile.mkdtemp(), "box.gltf"), with_light=False,
                          base_color=(1.0, 1.0, 1.0, 1.0), roughness=0.5)
    scene = load_gltf(path)
    m = scene.materials
    ones = np.ones_like(np.asarray(m.metalness_factor))
    change = {
        "metal": dict(metalness_factor=ones),
        "clearcoat": dict(clearcoat_factor=ones, clearcoat_roughness_factor=0.4 * ones),
        "sheen": dict(sheen_color_factor=np.ones_like(np.asarray(m.sheen_color_factor)),
                      sheen_roughness_factor=0.5 * ones),
        "transmission": dict(transmission_factor=ones),
    }[layer]
    m = m._replace(**change)
    m = m._replace(rows=PT.pack_material_rows(m))
    world, lights = world_from_scene(scene)
    return ppt.make_pt_scene(world, m, scene.textures, lights, device="cpu")


@pytest.mark.parametrize("layer", ["metal", "clearcoat", "sheen", "transmission"])
def test_layer_furnace_no_energy_gain(layer):
    """A white material with one extra layer in a uniform environment must
    gain no energy (the sampled layers' weights, pdfs and MIS compose to at
    most 1) and keep most of it."""
    scene, meta = _furnace_box(layer)
    flag = {"metal": None, "clearcoat": "has_clearcoat", "sheen": "has_sheen",
            "transmission": "has_transmission"}[layer]
    assert flag is None or getattr(meta, flag)
    c2w = camera.clip_to_world(camera.look_at([0.0, -2.0, 0.0], [0.0, 0.0, 0.0]),
                               y_fov=np.pi / 3, aspect=1.0, z_near=0.01)
    settings = PS.PathTracerSettings(max_bounces=5, min_bounces=5, environment_map=False,
                                     point_lights=False, luminance_clamp_enabled=False)
    params = PS.PathTracerParams(environment_color=(0.5, 0.5, 0.5))
    imgs = [ppt.trace(scene, meta, settings, params, c2w, (32, 32), s).numpy()
            for s in range(16)]
    center = np.mean(imgs, 0)[12:20, 12:20].mean(axis=(0, 1))
    assert np.all(center <= 0.5 * 1.08), (layer, center)
    assert np.all(center >= 0.5 * 0.55), (layer, center)


def test_count_ops_counts_each_traversal_as_one_op(zoo):
    """`tools/count_ops` on the zoo: one traversal a chunk and bounce (the
    zoo has no alpha hop), each counted as one op, its plain version's ops
    left out of the count."""
    from gltf_renderer_tpu_torch.tools import count_ops

    settings = PS.PathTracerSettings(max_bounces=2, min_bounces=2)
    args = (zoo["pscene"], zoo["pmeta"], settings, PS.PathTracerParams(),
            materials_camera(*count_ops.RES))
    got = count_ops.count(*args)
    assert got["traversals"] == got["chunks"] * (1 + settings.max_bounces)
    with count_ops._Count() as mode:
        ppt.trace_chunked(*args, count_ops.RES, 1, with_stats=True, spp=count_ops.SPP)
    every = sum(mode.ops.values())
    assert 0 < got["ops"] < every - 100 * got["traversals"], (got, every)
