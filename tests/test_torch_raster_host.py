"""The port's host-binned rasterizer (ops/raster.rasterize: build_setup,
_clip_near_host, bin_triangles, then the tile z-buffer) against the JAX
package's (gltf_renderer_tpu/ops/pallas_raster.rasterize, its Pallas
kernel in interpret mode at 256x128) and against the port's own
device-binned `rasterize_device`, on the box scene with the normal and
the near-plane-crossing cameras of tests/test_pallas_raster.py.

- `bin_triangles` is numpy in both packages: on the same setup (either
  package's) the CSR lists are equal bit for bit; `_clip_near_host` on the
  same clip coordinates gives the same pieces bit for bit.
- `build_setup`: the valid mask and the integer rows are equal exactly;
  the float rows of unclipped triangles agree to 1e-6 relative to each
  column's largest value (the JAX clip transform is a matrix product whose
  sums XLA:CPU may fuse; the port sums in index order); the near-clipped
  pieces' vertices lie near 1e8, where those last bits move whole pixels
  (tests/test_torch_raster.py), so they are compared only through the
  image below.
- The whole `rasterize`: the chosen triangle as tests/test_torch_raster.py
  holds `rasterize_device` (at most 0.1% of pixels differ with the normal
  camera, 3% with the near-clipped one; z, u, v within 1e-5 there, 99th
  percentiles within 0.005 / 0.05 on near-clipped pixels).
- Host against device binning, as test_device_binning_matches_host, held
  to the same rule as against JAX: the two clip the near-plane crossers
  into different fans (the host loop fans from the first kept vertex, the
  device from the lone one), which on the near-clipped, unculled view
  changes the triangle of 1.1% of pixels (measured; the JAX test's view
  culls every face there and compares nothing). On the CPU the tile pass
  is the plain version (one REFERENCE_CALLS count, no launch). A view with
  no triangle on screen gives the clear values.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.ops import pallas_raster as jr
from gltf_renderer_tpu_torch.ops import raster as pr
from tests.test_torch_raster import _t, box  # noqa: F401  (box: module fixture)

torch.set_num_threads(2)
W, H = 256, 128
CAMS = [(0, 1, 0.999), (1, 0, 0.97)]  # (camera, cull, share of pixels choosing the same triangle)
CAM_IDS = ["normal", "near_clipped"]


def _setups(world, w2c):
    jax_setup = jr.build_setup(jnp.asarray(world.position), jnp.asarray(world.tri_vertex),
                               jnp.asarray(w2c), W, H,
                               double_sided=jnp.asarray(world.tri_double_sided))
    port_setup = pr.build_setup(_t(world.position), _t(world.tri_vertex), w2c, W, H,
                                double_sided=_t(world.tri_double_sided))
    return jax_setup, port_setup


@pytest.mark.parametrize("cam", [0, 1], ids=CAM_IDS)
def test_setup_and_bins_match_jax(box, cam):
    world, cams = box
    jax_setup, port_setup = _setups(world, cams[cam])
    np.testing.assert_array_equal(port_setup.valid, jax_setup.valid)
    np.testing.assert_array_equal(port_setup.rows_i.numpy(), np.asarray(jax_setup.rows_i))
    n = len(world.tri_vertex)
    keep = port_setup.valid[:n]
    got, want = port_setup.rows.numpy()[:n][keep], np.asarray(jax_setup.rows)[:n][keep]
    assert (np.abs(got - want) <= 1e-6 * np.abs(want).max(0)).all()
    assert (len(port_setup.valid) > n) == (cam == 1)  # the near camera clips pieces
    for setup in (jax_setup, port_setup):
        p_flat, p_off, p_tiles = pr.bin_triangles(setup, W, H)
        j_flat, j_off, _, j_tiles = jr.bin_triangles(setup, W, H)
        assert p_tiles == j_tiles == pr.tile_grid(W, H)
        assert p_flat.dtype == p_off.dtype == np.int32
        np.testing.assert_array_equal(p_flat, j_flat)
        np.testing.assert_array_equal(p_off, j_off)
        assert len(p_flat) > 0 and p_off[-1] == len(p_flat)


def test_clip_near_host_matches_jax(box):
    world, cams = box
    _, clip, summary = jr._setup_device(jnp.asarray(world.position),
                                        jnp.asarray(world.tri_vertex), jnp.asarray(cams[1]),
                                        W, H, None)
    clip, summary = np.asarray(clip), np.asarray(summary)
    keep, cross = summary[:, 4] > 0.5, summary[:, 5] > 0.5
    assert cross.sum() >= 4
    got = pr._clip_near_host(clip, np.asarray(world.tri_vertex), keep, cross)
    want = jr._clip_near_host(clip, np.asarray(world.tri_vertex), keep, cross)
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype
        np.testing.assert_array_equal(g, wnt)
    assert len(got[2]) >= cross.sum()


def _hold(got, want, cam, agree):
    """tests/test_torch_raster.py's rule for two visibility buffers."""
    z, tri, u, v = got
    same = tri == want[1]
    assert same.mean() >= agree, same.mean()
    assert (tri >= 0).mean() > 0.03
    for g, wnt, tol in ((z, want[0], 0.005), (u, want[2], 0.05), (v, want[3], 0.05)):
        diff = np.abs(g[same] - wnt[same])
        if cam == 0:
            assert diff.max() <= 1e-5, diff.max()
        else:
            assert np.percentile(diff, 99) <= tol, np.percentile(diff, 99)


@pytest.mark.parametrize("cam,cull,agree", CAMS, ids=CAM_IDS)
def test_rasterize_matches_jax(box, cam, cull, agree):
    world, cams = box
    want = [np.asarray(x) for x in jr.rasterize(
        jnp.asarray(world.position), jnp.asarray(world.tri_vertex), jnp.asarray(cams[cam]), W, H,
        double_sided=jnp.asarray(world.tri_double_sided), cull_backfaces=bool(cull),
        interpret=True)]
    launches, calls = pr.KERNEL_LAUNCHES, pr.REFERENCE_CALLS
    z, tri, u, v = (x.numpy() for x in pr.rasterize(
        _t(world.position), _t(world.tri_vertex), cams[cam], W, H,
        double_sided=_t(world.tri_double_sided), cull_backfaces=bool(cull)))
    assert pr.KERNEL_LAUNCHES == launches and pr.REFERENCE_CALLS == calls + 1
    assert z.shape == (H, W) and tri.dtype == np.int32
    _hold((z, tri, u, v), want, cam, agree)


@pytest.mark.parametrize("cam,cull,agree", CAMS, ids=CAM_IDS)
def test_host_binning_matches_device(box, cam, cull, agree):
    world, cams = box
    args = (_t(world.position), _t(world.tri_vertex), cams[cam], W, H)
    host = [x.numpy() for x in pr.rasterize(
        *args, double_sided=_t(world.tri_double_sided), cull_backfaces=bool(cull))]
    dev = [x.numpy() for x in pr.rasterize_device(
        *args, double_sided=_t(world.tri_double_sided), cull_sign=cull)]
    _hold(host, dev, cam, agree)


def test_no_triangle_on_screen(box):
    world, cams = box
    above = _t(world.position + np.float32([0.0, 0.0, 1000.0]))  # far above the view
    setup = pr.build_setup(above, _t(world.tri_vertex), cams[0], W, H)
    flat, offsets, _ = pr.bin_triangles(setup, W, H)
    assert len(flat) == 0 and not offsets.any()
    z, tri, u, v = pr.rasterize(above, _t(world.tri_vertex), cams[0], W, H)
    assert (tri == -1).all() and not z.any() and not u.any() and not v.any()
