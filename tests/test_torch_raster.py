"""Torch port tile rasterizer (ops/raster.py) vs the JAX package.

Identical inputs go through both packages' stages:

- binning (`_bin_device`) on the same setup rows: the pair list and CSR
  offsets are equal exactly, including with a pair cap that drops pairs;
- near-plane clipping (`_clip_near_device`) on the same clip coordinates:
  the crosser set (source ids and piece validity) is equal exactly; the
  piece vertices and barycentrics agree to 1e-6 relative (XLA:CPU contracts
  p + s * (q - p) into a fused multiply-add, the port rounds each step);
- the per-tile z-buffer: `rasterize_tiles_ref` against the TPU kernel run in
  interpret mode on the same rows, list and offsets, with cull 0 and 1 and
  double-sided triangles. The chosen triangle is equal exactly; z, u and v
  agree to 1e-6 absolute (the same fused multiply-adds in the interpreted
  kernel move the last bits of the edge functions and interpolants; values
  are in [0, 1]);
- the whole visibility stage (`rasterize_device`) on the box scene with the
  normal and the near-plane-crossing cameras of tests/test_pallas_raster.py.
  With the normal camera at most 0.1% of pixels may choose another triangle
  (measured: none). Near-clipped pieces end at w = 1e-6, so their clipped
  vertices project to screen coordinates near 1e8, where the last-bit
  differences of the clip (fused multiply-adds in XLA:CPU) move the pieces'
  long edges by whole pixels and open or close one-pixel cracks along them:
  there at most 3% of pixels may differ (measured 751 of 32,768, 2.3%).
  The same huge coordinates make depth and barycentric interpolation over
  the pieces ill-conditioned in either package (measured on pixels that
  agree: |du| up to 0.25, 99th percentile 0.020; |dz| up to 0.036, 99th
  percentile 0.0029), so there the 99th percentiles are held to 0.05 for
  u, v and 0.005 for z; with the normal camera z, u and v agree to 1e-5.
  ROADMAP section C records the ill-conditioning as a fault of the clip.

JAX interpret-mode calls are kept at 256x128 pixels or less and share
module-scoped fixtures.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.ops import pallas_raster as jr
from gltf_renderer_tpu_torch.ops import raster as pr

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_rows(n, w, h, seed):
    """(n, 24) setup rows of random screen triangles (some off screen, some
    large, a few degenerate, some exact duplicates so depths tie) and their
    (n, 8) integer rows with random double-sided flags."""
    rs = np.random.default_rng(seed)
    c = rs.uniform([-40, -20], [w + 40, h + 20], (n, 2))
    size = np.where(rs.random(n) < 0.1, 120.0, 18.0)[:, None]
    xy = c[:, None, :] + rs.uniform(-1, 1, (n, 3, 2)) * size[:, :, None]
    xy[:4, 2] = xy[:4, 1]                         # degenerate
    z = rs.uniform(0.05, 1.05, (n, 3))           # some beyond the far limit
    iw = rs.uniform(0.5, 2.0, (n, 3))
    bary = np.tile([0.0, 0.0, 1.0, 0.0, 0.0, 1.0], (n, 1))
    bary[n // 2:] = rs.random((n - n // 2, 6))   # clipped-piece style
    rows = np.concatenate([xy.reshape(n, 6), z, iw, bary, np.zeros((n, 6))], 1)
    rows[-8:] = rows[8:16]                        # exact duplicates: ties
    rows_i = np.zeros((n, 8), np.int32)
    rows_i[:, 0] = np.arange(n)
    rows_i[:, 1] = rs.random(n) < 0.3
    valid = rs.random(n) < 0.9
    return rows.astype(np.float32), rows_i, valid


@pytest.mark.parametrize("pair_cap", [64, 4096])
def test_binning_matches_jax(pair_cap):
    w, h = 300, 70
    rows, _, valid = _random_rows(300, w, h, seed=1)
    j_list, j_off, tiles = jr._bin_device(jnp.asarray(rows), jnp.asarray(valid), w, h, pair_cap)
    p_list, p_off, n_pairs = pr._bin_device(_t(rows), _t(valid), w, h, pair_cap)
    assert tiles == pr.tile_grid(w, h)
    np.testing.assert_array_equal(p_list.numpy(), np.asarray(j_list))
    np.testing.assert_array_equal(p_off.numpy(), np.asarray(j_off))
    assert (int(n_pairs) > pair_cap) == (pair_cap == 64)  # the small cap drops pairs


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """World geometry of the box scene and the two cameras'
    world_to_clip matrices (normal, near-plane crossing)."""
    from gltf_renderer_tpu.camera import Camera, look_at
    from gltf_renderer_tpu.scene import flatten
    from gltf_renderer_tpu.scene.gltf import load_gltf
    from tests.scenes import write_box_gltf

    scene = load_gltf(write_box_gltf(str(tmp_path_factory.mktemp("r") / "box.gltf")))
    tf = flatten.compute_global_transforms(scene)
    plan = flatten.build_instance_plan(scene)
    world = jax.tree.map(np.asarray, flatten.build_world_geometry(
        jax.tree.map(jnp.asarray, scene.pools), plan, jnp.asarray(tf),
        jnp.asarray(flatten.normal_transforms(tf)), flatten.plan_tri_flags(plan, scene.primitives)))
    cams = []
    for eye, target in (([2.0, -2.0, 1.5], [0, 0, 0]), ([0.45, 0.0, 0.0], [-1.0, 0.0, 0.0])):
        cam = Camera(y_fov=np.pi / 3, aspect_ratio=2.0, z_near=0.05)
        cam.world_to_view = look_at(eye, target)
        cams.append(cam.world_to_clip().astype(np.float32))
    return world, cams


def test_near_clip_matches_jax(box):
    world, cams = box
    w, h = 256, 128
    _, clip, summary = jr._setup_device(jnp.asarray(world.position), jnp.asarray(world.tri_vertex),
                                        jnp.asarray(cams[1]), w, h, None)
    clip = np.asarray(clip)
    cross = np.asarray(summary)[:, 5] > 0.5
    assert cross.sum() >= 4
    for cap in (2, pr.CLIP_CAP):
        want = [np.asarray(x) for x in jr._clip_near_device(
            jnp.asarray(clip), jnp.asarray(world.tri_vertex), jnp.asarray(cross), cap)]
        got = [x.numpy() for x in pr._clip_near_device(
            _t(clip), _t(world.tri_vertex), _t(cross), cap)]
        np.testing.assert_array_equal(got[2], want[2])   # source ids
        np.testing.assert_array_equal(got[3], want[3])   # piece validity
        for g, wnt in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, wnt, rtol=1e-6, atol=1e-6 * np.abs(wnt).max())
        # Port setup of the same clip coordinates: the same keep / cross sets.
    _, _, keep, p_cross = pr._setup_device(_t(world.position), _t(world.tri_vertex),
                                           _t(cams[1]), w, h)
    np.testing.assert_array_equal(p_cross.numpy(), cross)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(summary)[:, 4] > 0.5)


@pytest.fixture(scope="module")
def tile_case():
    """Random rows binned once (the JAX binning, which the port equals)."""
    w, h = 256, 32
    rows, rows_i, valid = _random_rows(160, w, h, seed=3)
    tri_list, offsets, tiles = jr._bin_device(jnp.asarray(rows), jnp.asarray(valid), w, h, 2048)
    return rows, rows_i, np.asarray(tri_list), np.asarray(offsets), tiles


@pytest.mark.parametrize("cull_sign", [0, 1])
def test_tiles_ref_matches_pallas_interpret(tile_case, cull_sign):
    rows, rows_i, tri_list, offsets, tiles = tile_case
    n_tiles = tiles[0] * tiles[1]
    want = [np.asarray(x) for x in jr.rasterize_tiles(
        jnp.asarray(rows), jnp.asarray(rows_i), jnp.asarray(tri_list), jnp.asarray(offsets),
        jnp.arange(n_tiles, dtype=jnp.int32), tiles, cull_sign=cull_sign, interpret=True)]
    got = [x.numpy() for x in pr.rasterize_tiles_ref(
        _t(rows), _t(rows_i), _t(tri_list), _t(offsets), tiles, cull_sign)]
    z, tri, u, v = got
    np.testing.assert_array_equal(tri, want[1])
    for g, wnt in ((z, want[0]), (u, want[2]), (v, want[3])):
        np.testing.assert_allclose(g, wnt, rtol=0, atol=1e-6)
    covered = tri >= 0
    assert 0.2 < covered.mean() < 1.0
    # Double-sided triangles survive culling: some back faces are drawn.
    if cull_sign:
        ids = tri[covered]
        r = rows[ids]
        area = (r[:, 2] - r[:, 0]) * (r[:, 5] - r[:, 1]) - (r[:, 3] - r[:, 1]) * (r[:, 4] - r[:, 0])
        assert ((area > 0) & (rows_i[ids, 1] == 1)).any()


# The near-plane camera sits inside the box and sees its faces from behind,
# so that case rasterizes without culling.
@pytest.mark.parametrize("cam,cull,agree", [(0, 1, 0.999), (1, 0, 0.97)],
                         ids=["normal", "near_clipped"])
def test_rasterize_device_matches_jax(box, cam, cull, agree):
    world, cams = box
    w, h = 256, 128
    want = [np.asarray(x) for x in jr.rasterize_device(
        jnp.asarray(world.position), jnp.asarray(world.tri_vertex), jnp.asarray(cams[cam]), w, h,
        double_sided=jnp.asarray(world.tri_double_sided), cull_sign=cull, interpret=True)]
    launches, calls = pr.KERNEL_LAUNCHES, pr.REFERENCE_CALLS
    got = [x.numpy() for x in pr.rasterize_device(
        _t(world.position), _t(world.tri_vertex), cams[cam], w, h,
        double_sided=_t(world.tri_double_sided), cull_sign=cull)]
    assert pr.KERNEL_LAUNCHES == launches and pr.REFERENCE_CALLS == calls + 1
    z, tri, u, v = got
    assert z.shape == (h, w) and tri.dtype == np.int32
    same = tri == want[1]
    assert same.mean() >= agree, same.mean()
    assert (tri >= 0).mean() > 0.03
    for g, wnt, tol in ((z, want[0], 0.005), (u, want[2], 0.05), (v, want[3], 0.05)):
        diff = np.abs(g[same] - wnt[same])
        if cam == 0:
            assert diff.max() <= 1e-5, diff.max()
        else:
            assert np.percentile(diff, 99) <= tol, np.percentile(diff, 99)


def test_wrapper_routes_cpu_to_plain_and_validates(tile_case):
    rows, rows_i, tri_list, offsets, tiles = tile_case
    args = [_t(rows), _t(rows_i), _t(tri_list), _t(offsets)]
    launches, calls = pr.KERNEL_LAUNCHES, pr.REFERENCE_CALLS
    out = pr.rasterize_tiles(*args, tiles, cull_sign=1)
    assert pr.KERNEL_LAUNCHES == launches and pr.REFERENCE_CALLS == calls + 1
    for a, b in zip(out, pr.rasterize_tiles_ref(*args, tiles, 1)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        pr.rasterize_tiles(args[0].double(), *args[1:], tiles)
    with pytest.raises(ValueError):
        pr.rasterize_tiles(*args, (tiles[0] + 1, tiles[1]))
    with pytest.raises(ValueError):
        pr.rasterize_tiles(*args, tiles, cull_sign=2)


def test_empty_frame_and_default_pair_cap():
    """No triangle on screen: every pixel keeps its clear values."""
    pos = _t(np.asarray([[0, 0, 5.0], [1, 0, 5.0], [0, 1, 5.0]], np.float32))
    tv = _t(np.asarray([[0, 1, 2]], np.int32))
    w2c = np.eye(4, dtype=np.float32)
    w2c[3] = [0, 0, -1, 0]  # w = -z: the triangle lies behind the eye
    z, tri, u, v = pr.rasterize_device(pos, tv, w2c, 130, 20)
    assert (tri.numpy() == -1).all() and (z.numpy() == 0).all()
    assert (u.numpy() == 0).all() and (v.numpy() == 0).all()
    assert pr.default_pair_cap(48768) == 262144 and pr.default_pair_cap(10) == 65536
