"""The port's full raster backend against the JAX package: the blend and
transmission pass, clearcoat IBL, punctual lights, the masked retry and
motion vectors.

Scenes come from the JAX package's writers and loader; both packages read
the same tables (`convert.from_jax_pt_scene`, the port's native BVH build
on both sides, the JAX side built with f32 rows and its mip pyramid as in
tests/test_torch_raster_shading.py), under the golden configurations' 32x64
analytic environment with small prefilters (`jax_raster_env`).

- `build_transmission_mips` for kernels 0, 1 and 2 on a seeded (16, 24, 3)
  image (two levels) and over the full chain of an odd (27, 13, 3) image,
  whose tail runs `post.bloom.downsample`'s bilinear five-tap path: within
  1e-6 absolute (measured 1.8e-7: XLA's fused multiply-adds in the taps).
  `_jimenez_conv_kernel` equals the JAX kernel.
- `shade_forward` on 512 fixed hits on the zoo (clearcoat IBL, the
  transmissive sphere sampling a seeded backdrop pyramid at random screen
  uv) and on the box lit by its point light, no environment: the shading
  tests' 1e-5 relative + 1e-6 absolute (measured: 4.0e-7 relative, 1.8e-7
  absolute).
- `motion_vectors` on fixed box hits with a moved camera: within 1e-4
  pixels (measured 3.8e-6; the f32 clip products and the division).
- `render` against JAX `_raster_step` in both visibilities (the tiled
  kernel in interpret mode), at the bar of tests/test_torch_raster_frame.py:
  HDR pixels within 1e-4 + 1e-3 relative on at least 99.5% of pixels, the
  means within 0.1%. On the zoo at 64x48 (4 blend layers over the
  transmissive sphere's backdrop, clearcoat), the box with its light and no
  environment at 64x64, the blended double box of
  tests/test_rasterizer.py::test_raster_alpha_blend at 64x64, and the
  courtyard at 64x36 (its banners' masked retry). Measured: every pixel
  within the bar on the zoo, the box and the courtyard (at most 2.7e-6
  apart); on the double box 15 (raycast) and 12 (tiled) of 4,096 pixels
  are not: the head-on view puts the front faces' diagonal edges through
  pixel centres, and a ray on a shared edge hits one triangle or slips
  between the two by the last bit, in either package (means 8.6e-5 and
  2.7e-4 apart). The retry's hit ids follow ROADMAP C's alpha-cutoff tie
  rule: they agree with the JAX loop's but on lanes whose first hit's base
  alpha lies within 1e-6 of the cutoff, at most 2. `with_motion` on the
  box with a moved camera, in both visibilities: the image as above, the
  motion vectors within 1e-4 pixels (measured 1.5e-5).
- Counts on the CPU's plain versions: a raycast frame makes one traversal
  call a chunk, one a retry hop (RASTER_RETRY_HOPS) and MAX_BLEND_LAYERS a
  chunk where the scene has blended or transmissive triangles; a tiled
  frame the same but the first, and one tile pass.

Port only: `box_scene` bit-identical to the JAX loader's read of
`write_box_gltf` (with and without the light, and with double_box), and the
port-built box-raster frame (`render_box_raster_golden`) in both
visibilities against tests/goldens/box_raster.png at the SSIM bar of
tests/test_ssim_baseline.py (0.99).
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu_torch import camera, convert
from gltf_renderer_tpu_torch.bench_scene import (
    analytic_equirect,
    render_box_raster_golden,
    world_from_scene,
)
from gltf_renderer_tpu_torch.ops import raster as praster
from gltf_renderer_tpu_torch.ops import traverse as ptr
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.render import rasterizer as prz
from gltf_renderer_tpu_torch.render import renderer as prend
from gltf_renderer_tpu_torch.render import settings as PS
from gltf_renderer_tpu_torch.scene.procedural import box_scene
from gltf_renderer_tpu_torch.utils.ssim import ssim
from tests.test_torch_alpha import jax_pt_scene
from tests.test_torch_raster_shading import RASTER_KNOBS, jax_raster_env
from tests.test_torch_scene import bits

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6
CUTOFF_TIE = 1e-6
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "box_raster.png")
VIS = ("raycast", "tiled")
# scene -> (resolution, eye, target)
VIEWS = {
    "zoo": ((64, 48), [0.0, -6.0, 3.0], [0.0, 0.0, 0.5]),
    "box": ((64, 64), [2.0, -2.0, 1.5], [0.0, 0.0, 0.0]),
    "blend_box": ((64, 64), [0.0, -3.0, 0.0], [0.0, 0.0, 0.0]),
    "courtyard": ((64, 36), [-9.0, 0.0, 1.7], [1.0, 0.0, 1.6]),
}
MOVED_EYE = [2.2, -1.9, 1.5]  # tests/test_rasterizer.py::test_raster_motion_vectors


def _t(x):
    return torch.from_numpy(np.array(x))


def _view(name, eye=None):
    (w, h), default_eye, target = VIEWS[name]
    w2v = camera.look_at(default_eye if eye is None else eye, target)
    return camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=w / h, z_near=0.01), \
        camera.position(w2v), (w, h)


def _both(src, env):
    """JAX and port scenes of a loaded Scene on the same tables."""
    from gltf_renderer_tpu.ops import bvh as jax_bvh
    from gltf_renderer_tpu_torch.ops import bvh as port_bvh

    with pytest.MonkeyPatch.context() as mp:
        for k, v in RASTER_KNOBS.items():
            mp.setenv(k, v)
        mp.setattr(jax_bvh, "_NATIVE", port_bvh._load_native())
        mp.setattr(jax_bvh, "_NATIVE_TRIED", True)
        jscene, jmeta, world, _ = jax_pt_scene(src, env)
    pscene, pmeta = convert.from_jax_pt_scene(jax.tree.map(np.asarray, jscene), jmeta, "cpu")
    return dict(jscene=jscene, jmeta=jmeta, pscene=pscene, pmeta=pmeta, world=world, src=src)


def _blend_box_gltf(path):
    """tests/test_rasterizer.py::test_raster_alpha_blend's scene: a green
    BLEND box (alpha 0.5) in front of an opaque red one."""
    from gltf_renderer_tpu.scene.procedural import write_box_gltf

    write_box_gltf(path, base_color=(0.0, 0.8, 0.0, 0.5), double_box=True)
    with open(path) as f:
        doc = json.load(f)
    doc["materials"][0]["alphaMode"] = "BLEND"
    doc["materials"].append({"pbrMetallicRoughness": {
        "baseColorFactor": [0.8, 0.0, 0.0, 1.0], "metallicFactor": 0.0, "roughnessFactor": 0.6}})
    doc["meshes"].append({"primitives": [dict(doc["meshes"][0]["primitives"][0], material=1)]})
    doc["nodes"][1]["mesh"] = 1
    doc["nodes"][1]["translation"] = [0.0, 0.0, -1.5]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from gltf_renderer_tpu.scene.gltf import load_gltf
    from gltf_renderer_tpu.scene.procedural import (
        write_box_gltf,
        write_courtyard_glb,
        write_materials_gltf,
    )

    d = tmp_path_factory.mktemp("blend")
    env = jax_raster_env(analytic_equirect())
    return {
        "zoo": _both(load_gltf(write_materials_gltf(str(d / "zoo.gltf"))), env),
        "box": _both(load_gltf(write_box_gltf(str(d / "box.gltf"))), None),
        "blend_box": _both(load_gltf(_blend_box_gltf(str(d / "blend.gltf"))), env),
        "courtyard": _both(load_gltf(write_courtyard_glb(str(d / "c.glb"), tex_size=64)), env),
    }


@pytest.fixture(scope="module")
def jax_frames(scenes):
    """JAX `_raster_step` HDR frames: {(scene, visibility): (h, w, 3)}."""
    from gltf_renderer_tpu.render import renderer as jrend
    from gltf_renderer_tpu.render import settings as JS

    out = {}
    for name, s in scenes.items():
        c2w, cam_pos, res = _view(name)
        rs = JS.RenderSettings(backend="rasterizer", width=res[0], height=res[1])
        for vis in VIS:
            out[name, vis] = np.asarray(jrend._raster_step(
                s["jscene"], s["jmeta"], rs, JS.PathTracerParams(), jnp.asarray(c2w),
                jnp.asarray(cam_pos), res, jnp.uint32(0), vis))
    return out


def _assert_frames_match(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    close = (np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


# --- The backdrop pyramid ---------------------------------------------------

@pytest.mark.parametrize("kernel", [0, 1, 2])
@pytest.mark.parametrize("shape", [(16, 24, 3), (27, 13, 3)], ids=["even", "odd"])
def test_transmission_mips_match_jax(kernel, shape):
    from gltf_renderer_tpu.render import rasterizer as jrz

    img = np.random.default_rng(5).random(shape).astype(np.float32)
    n_mips = 2 if shape[0] == 16 else None  # the odd image runs the full chain
    want = jrz.build_transmission_mips(jnp.asarray(img), n_mips=n_mips, kernel=kernel)
    got = prz.build_transmission_mips(_t(img), n_mips=n_mips, kernel=kernel)
    assert len(got) == len(want) == (2 if n_mips else 5)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_jimenez_conv_kernel_equals_jax():
    from gltf_renderer_tpu.render import rasterizer as jrz

    np.testing.assert_array_equal(prz._jimenez_conv_kernel(), jrz._jimenez_conv_kernel())


# --- shade_forward on fixed hits ---------------------------------------------

def _hits(world, n=512, seed=0):
    """Hits spread over every material's triangles (zero-area pole
    triangles left out), random unit directions (back faces occur), hit
    distances and screen uv."""
    rs = np.random.default_rng(seed)
    pos, tv = np.asarray(world.position), np.asarray(world.tri_vertex)
    mat = np.asarray(world.tri_material)
    e1, e2 = pos[tv[:, 1]] - pos[tv[:, 0]], pos[tv[:, 2]] - pos[tv[:, 0]]
    ok = np.linalg.norm(np.cross(e1, e2), axis=-1) > 1e-3 * (
        np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1))
    mats = np.unique(mat)
    tri = np.concatenate([rs.choice(np.nonzero(ok & (mat == m))[0], n // len(mats))
                          for m in mats]).astype(np.int32)
    k = tri.shape[0]
    uv = rs.random((k, 2)).astype(np.float32)
    flip = uv.sum(-1) > 1.0
    uv[flip] = 1.0 - uv[flip]
    d = rs.normal(size=(k, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rs.uniform(0.5, 3.0, k).astype(np.float32)
    screen_uv = rs.random((k, 2)).astype(np.float32)
    return tri, uv[:, 0].copy(), uv[:, 1].copy(), d, t, screen_uv


@pytest.mark.parametrize("name", ["zoo", "box"])
def test_shade_forward_matches_jax(scenes, name):
    """The zoo with clearcoat IBL and the transmissive sphere over a seeded
    backdrop pyramid; the box under its point light, no environment."""
    from gltf_renderer_tpu.ops import bvh as jbvh
    from gltf_renderer_tpu.render import rasterizer as jrz

    s = scenes[name]
    jm, pm = s["jmeta"], s["pmeta"]
    if name == "zoo":
        assert pm.has_clearcoat and pm.has_transmission and pm.has_env and pm.num_lights == 0
        backdrop = np.random.default_rng(3).random((24, 32, 3)).astype(np.float32) * 2.0
        jmips = jrz.build_transmission_mips(jnp.asarray(backdrop))
        pmips = [_t(np.asarray(m)) for m in jmips]
    else:
        assert pm.num_lights == 1 and not pm.has_env
        jmips = pmips = None
    tri, u, v, d, t, screen_uv = _hits(s["world"])
    origin = -d * t[:, None]
    jhit = jbvh.Hit(t=jnp.asarray(t), tri=jnp.asarray(tri), u=jnp.asarray(u), v=jnp.asarray(v))
    want = jrz.shade_forward(s["jscene"], jm, jhit, jnp.asarray(origin), jnp.asarray(d),
                             jnp.zeros(3), 1.0, jnp.asarray(screen_uv),
                             transmission_mips=jmips, use_env=True, use_lights=True)
    phit = ppt.Hit(t=_t(t), tri=_t(tri).long(), u=_t(u), v=_t(v))
    got = prz.shade_forward(s["pscene"], pm, phit, _t(origin), _t(d), torch.zeros(3), 1.0,
                            _t(screen_uv), transmission_mips=pmips, use_env=True,
                            use_lights=True)
    rgb = got[0].numpy()
    assert np.isfinite(rgb).all() and rgb.max() > 0.05
    np.testing.assert_allclose(rgb, np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Each feature reaches the image: the backdrop and the coat on the zoo,
    # the light on the box.
    if name == "zoo":
        plain = prz.shade_forward(s["pscene"], pm._replace(has_clearcoat=False), phit, _t(origin),
                                  _t(d), torch.zeros(3), 1.0, _t(screen_uv))[0].numpy()
        coat = np.asarray(s["world"].tri_material)[tri] == 2
        glass = np.asarray(s["world"].tri_material)[tri] == 1
        assert np.abs(plain - rgb)[coat].max() > 1e-2 and np.abs(plain - rgb)[glass].max() > 1e-2
    else:
        unlit = prz.shade_forward(s["pscene"], pm, phit, _t(origin), _t(d), torch.zeros(3), 1.0,
                                  None, use_lights=False)[0].numpy()
        assert np.abs(rgb - unlit).max() > 1e-2


def test_motion_vectors_match_jax(scenes):
    from gltf_renderer_tpu.ops import bvh as jbvh
    from gltf_renderer_tpu.render import rasterizer as jrz

    s = scenes["box"]
    tri, u, v, _, t, _ = _hits(s["world"], n=256, seed=2)
    tri[:16] = -1
    rs = np.random.default_rng(4)
    px, py = rs.integers(0, 64, (2, tri.shape[0])).astype(np.int32)
    prev_w2c = camera.world_to_clip(_view("box", MOVED_EYE)[0])
    want = jrz.motion_vectors(
        s["jscene"].world, jbvh.Hit(t=jnp.asarray(t), tri=jnp.asarray(tri), u=jnp.asarray(u),
                                    v=jnp.asarray(v)),
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(prev_w2c), resolution=(64, 64))
    got = prz.motion_vectors(s["pscene"].world,
                             ppt.Hit(t=_t(t), tri=_t(tri).long(), u=_t(u), v=_t(v)),
                             _t(px), _t(py), _t(prev_w2c), resolution=(64, 64)).numpy()
    assert (got[:16] == 0).all() and np.abs(got[16:]).max() > 0.1
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


# --- Whole frames -------------------------------------------------------------

@pytest.mark.parametrize("vis", VIS)
@pytest.mark.parametrize("name", list(VIEWS))
def test_render_matches_jax(scenes, jax_frames, name, vis):
    s = scenes[name]
    c2w, cam_pos, res = _view(name)
    rs = PS.RenderSettings(backend="rasterizer", width=res[0], height=res[1])
    calls = (ptr.REFERENCE_CALLS, praster.REFERENCE_CALLS)
    hops = prz.RASTER_RETRY_HOPS
    got = prend.raster_step(s["pscene"], s["pmeta"], rs, PS.PathTracerParams(), c2w, cam_pos,
                            res, 0, visibility=vis).numpy()
    # The plain versions run on CPU tensors: one chunk's opaque launch (raycast
    # only), one a retry hop, MAX_BLEND_LAYERS in the blend pass; one tile pass.
    hops = prz.RASTER_RETRY_HOPS - hops
    k1 = ((vis == "raycast") + hops + prz.MAX_BLEND_LAYERS * s["pmeta"].has_blend)
    assert (ptr.REFERENCE_CALLS - calls[0], praster.REFERENCE_CALLS - calls[1]) == \
        (k1, int(vis == "tiled"))
    assert (hops > 0) == (name == "courtyard")
    _assert_frames_match(got, jax_frames[name, vis])


def test_courtyard_retry_matches_jax_but_ties(scenes):
    """The raster retry's hit ids against the JAX loop's on the courtyard's
    camera rays: equal but on lanes whose first hit's base alpha lies within
    CUTOFF_TIE of the cutoff (ROADMAP C), at most 2."""
    from gltf_renderer_tpu.ops import bvh as jbvh
    from gltf_renderer_tpu.render import rasterizer as jrz

    s = scenes["courtyard"]
    c2w, _, res = _view("courtyard")
    px, py, _ = ppt._tile_order(*res, "cpu")
    o, d, t_max = prz._pixel_rays(px, py, res, torch.as_tensor(c2w))
    first = ppt.closest_hit(s["pscene"], s["pmeta"], o, d, torch.zeros_like(t_max), t_max,
                            blend_mode=1)
    got = prz._alpha_retry_raster(s["pscene"], s["pmeta"], first, o, d, t_max)
    jfirst = jbvh.Hit(*(jnp.asarray(x.numpy()) for x in first))
    want = jax.jit(jrz._alpha_retry_raster, static_argnums=(1,))(
        s["jscene"], s["jmeta"], jfirst, *(jnp.asarray(x.numpy()) for x in (o, d, t_max)))
    alpha, _ = ppt._hit_base_alpha(s["pscene"], s["pmeta"], first.tri, first.u, first.v)
    rejected = (got.tri != first.tri).numpy()
    assert rejected.sum() > 50  # rays through the banners' cutouts
    tie = ((torch.abs(alpha - 0.5) <= CUTOFF_TIE) & (first.tri >= 0)).numpy()
    differ = got.tri.numpy() != np.asarray(want.tri)
    assert not (differ & ~tie).any() and differ.sum() <= 2
    same = ~differ
    np.testing.assert_allclose(got.t.numpy()[same], np.asarray(want.t)[same], rtol=1e-6)


@pytest.mark.parametrize("vis", VIS)
def test_with_motion_matches_jax(scenes, vis):
    from gltf_renderer_tpu.render import rasterizer as jrz
    from gltf_renderer_tpu.render import settings as JS

    s = scenes["box"]
    c2w, cam_pos, res = _view("box", MOVED_EYE)
    prev_w2c = camera.world_to_clip(_view("box")[0])
    jlit, jmv = jax.jit(jrz.render, static_argnums=(1, 2, 6, 10, 11))(
        s["jscene"], s["jmeta"], JS.RenderSettings(), JS.PathTracerParams(), jnp.asarray(c2w),
        jnp.asarray(cam_pos), res, jnp.uint32(0), jnp.asarray(prev_w2c), None, True, vis)
    lit, mv = prz.render(s["pscene"], s["pmeta"], PS.RenderSettings(), PS.PathTracerParams(),
                         c2w, cam_pos, res, 0, prev_world_to_clip=prev_w2c, with_motion=True,
                         visibility=vis)
    _assert_frames_match(lit.numpy(), np.asarray(jlit))
    mv = mv.numpy()
    assert mv.shape == (res[1], res[0], 2) and np.abs(mv).max() > 0.5
    np.testing.assert_allclose(mv, np.asarray(jmv), rtol=0, atol=1e-4)
    # Without a previous matrix the camera did not move: 0 up to rounding.
    _, still = prz.render(s["pscene"], s["pmeta"], PS.RenderSettings(), PS.PathTracerParams(),
                          c2w, cam_pos, res, 0, with_motion=True, visibility=vis)
    assert np.abs(still.numpy()).max() < 1e-2


# --- The box -------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(with_light=False), dict(double_box=True)],
                         ids=["light", "no_light", "double_box"])
def test_box_scene_tables_equal_loader(tmp_path, kw):
    from gltf_renderer_tpu.scene.gltf import load_gltf
    from gltf_renderer_tpu.scene.procedural import write_box_gltf

    j = load_gltf(write_box_gltf(str(tmp_path / "box.gltf"), **kw))
    p = box_scene(**kw)
    for grp in ("pools", "primitives", "materials"):
        for f in getattr(p, grp)._fields:
            a, b = getattr(getattr(j, grp), f), getattr(getattr(p, grp), f)
            assert np.asarray(a).shape == np.asarray(b).shape, (grp, f)
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"{grp}.{f}")
    for f in ("rows", "atlas", "x", "width"):
        np.testing.assert_array_equal(bits(getattr(j.textures, f)), bits(getattr(p.textures, f)))
    np.testing.assert_array_equal(j.topo_order, p.topo_order)
    _, _, jworld, jlights = jax_pt_scene(j)
    world, lights = world_from_scene(p)
    assert len(lights.type) == int(kw.get("with_light", True))
    for f in world._fields:
        np.testing.assert_array_equal(bits(getattr(jworld, f)), bits(getattr(world, f)),
                                      err_msg=f)
    for f in lights._fields:
        np.testing.assert_array_equal(bits(getattr(jlights, f)), bits(getattr(lights, f)),
                                      err_msg=f)


@pytest.mark.parametrize("vis", VIS)
def test_box_raster_golden(vis):
    from PIL import Image

    img = render_box_raster_golden("cpu", vis).numpy()
    golden = np.asarray(Image.open(GOLDEN))
    assert img.shape == golden.shape
    assert ssim(img, golden) >= 0.99
