"""The CUDA tile-rasterizer kernel against its plain PyTorch version, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_raster_cuda.py -q

Without a CUDA device every test here skips (the kernel has no CPU mode).
Tolerance: none. The kernel and `rasterize_tiles_ref` test triangles in the
same order and round every operation the same way (the kernel is built with
-fmad=false) and merge work items by the largest (depth, first listed)
key, so z, tri, u and v are identical bit for bit. Cases: a tile list of
several work items, mostly empty tiles, a near-clipped view, a ragged last
tile row, a "pole" (thousands of tiny triangles in one tile, duplicates at
equal depth on both sides of every item boundary), needles at the edge of
the sub-tile rejection rule's error bound, and lists of exactly one work
item and one entry more, each under cull -1, 0 and +1.
"""

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch import camera
from gltf_renderer_tpu_torch.ops import raster

import raster_soups

pytestmark = pytest.mark.cuda

BATCH = raster.CHUNK  # list entries of one work item (RASTER_CHUNK in csrc/raster.cu)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _binned(rows, rows_i, valid, w, h, device):
    rows_t, valid_t = torch.from_numpy(rows).to(device), torch.from_numpy(valid).to(device)
    tri_list, offsets, _ = raster._bin_device(rows_t, valid_t, w, h, 1 << 16)
    return (rows_t, torch.from_numpy(rows_i).to(device), tri_list, offsets,
            raster.tile_grid(w, h))


def _assert_kernel_equals_plain(args):
    launches = raster.KERNEL_LAUNCHES
    for cull in (-1, 0, 1):
        got = raster.rasterize_tiles(*args, cull_sign=cull)
        want = raster.rasterize_tiles_ref(*args, cull_sign=cull)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert (want[1] >= 0).any()
    assert raster.KERNEL_LAUNCHES == launches + 3


def test_list_longer_than_one_batch(cuda_device):
    rows, rows_i, valid = raster_soups.soup(700, (0, 0, 128, 16), seed=1, size=6.0)
    args = _binned(rows, rows_i, valid, 256, 32, cuda_device)
    counts = torch.diff(args[3])
    assert int(counts.max()) > 3 * BATCH
    _assert_kernel_equals_plain(args)


def test_mostly_empty_tiles(cuda_device):
    rows, rows_i, valid = raster_soups.soup(40, (500, 150, 640, 200), seed=2)
    args = _binned(rows, rows_i, valid, 640, 200, cuda_device)
    counts = torch.diff(args[3])
    assert int((counts == 0).sum()) > counts.numel() // 2
    _assert_kernel_equals_plain(args)
    z, tri, u, v = raster.rasterize_tiles(*args)
    empty = (counts == 0).reshape(args[4][1], args[4][0])
    ty, tx = [int(i) for i in torch.nonzero(empty)[0]]
    tile = tri[ty * 16:(ty + 1) * 16, tx * 128:(tx + 1) * 128]
    assert (tile == -1).all()
    assert (z[ty * 16:(ty + 1) * 16, tx * 128:(tx + 1) * 128] == 0).all()


def _sphere(n_lat=48, n_lon=96):
    from gltf_renderer_tpu_torch.scene.procedural import uv_sphere

    p, _, _, idx = uv_sphere(n_lat, n_lon)
    return p.astype(np.float32), idx.reshape(-1, 3).astype(np.int32)


def test_near_clipped_view(cuda_device):
    pos, tv = _sphere()
    w2v = camera.look_at([0.52, 0.0, 0.0], [0.52, 1.0, 0.0])  # the camera plane cuts the sphere
    c2w = camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=640 / 360, z_near=0.01)
    ins = raster.prepare_tiles(torch.from_numpy(pos).to(cuda_device),
                               torch.from_numpy(tv).to(cuda_device), camera.world_to_clip(c2w),
                               640, 360)
    assert int(ins.n_cross) > 0
    _assert_kernel_equals_plain((ins.rows, ins.rows_i, ins.tri_list, ins.offsets, ins.tiles))


def test_ragged_last_tile_row(cuda_device):
    pos, tv = _sphere()
    w, h = 300, 100  # neither a multiple of 128 nor of 16
    w2v = camera.look_at([1.1, -1.1, 0.6], [0.0, 0.0, 0.0])
    c2w = camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=w / h, z_near=0.01)
    ins = raster.prepare_tiles(torch.from_numpy(pos).to(cuda_device),
                               torch.from_numpy(tv).to(cuda_device), camera.world_to_clip(c2w),
                               w, h)
    assert ins.tiles == (3, 7)
    _assert_kernel_equals_plain((ins.rows, ins.rows_i, ins.tri_list, ins.offsets, ins.tiles))
    z, tri, u, v = raster.rasterize_device(torch.from_numpy(pos).to(cuda_device),
                                           torch.from_numpy(tv).to(cuda_device),
                                           camera.world_to_clip(c2w), w, h)
    assert tri.shape == (h, w) and (tri >= 0).any()


def test_pole_across_many_items(cuda_device):
    rows, rows_i, valid, pairs = raster_soups.pole()
    args = _binned(rows, rows_i, valid, *raster_soups.POLE_SIZE, cuda_device)
    assert int(torch.diff(args[3])[3]) > 30 * BATCH
    _assert_kernel_equals_plain(args)
    tri = raster.rasterize_tiles(*args, cull_sign=0)[1]
    won = set(torch.unique(tri).tolist())
    assert not won & {copy for _, copy in pairs}
    assert len(won & {first for first, _ in pairs}) >= 0.9 * len(pairs)


def test_needles_at_the_rejection_bound(cuda_device):
    for seed in (3, 4):
        rows, rows_i, valid = raster_soups.needles(seed=seed)
        _assert_kernel_equals_plain(_binned(rows, rows_i, valid, 256, 64, cuda_device))


@pytest.mark.parametrize("extra", [0, 1])
def test_list_of_exactly_one_item(cuda_device, extra):
    rows, rows_i, valid = raster_soups.one_tile(BATCH + extra, seed=9)
    args = _binned(rows, rows_i, valid, 128, 16, cuda_device)
    assert args[3].tolist() == [0, BATCH + extra]
    _assert_kernel_equals_plain(args)
