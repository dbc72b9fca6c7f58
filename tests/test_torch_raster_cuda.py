"""The CUDA tile-rasterizer kernel against its plain PyTorch version, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_raster_cuda.py -q

Without a CUDA device every test here skips (the kernel has no CPU mode).
Tolerance: none. The kernel and `rasterize_tiles_ref` test triangles in the
same order and round every operation the same way (the kernel is built with
-fmad=false), so z, tri, u and v are identical bit for bit. Cases: a tile
list longer than one shared-memory batch, mostly empty tiles, a near-clipped
view, and a ragged last tile row, each under cull -1, 0 and +1.
"""

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch import camera
from gltf_renderer_tpu_torch.ops import raster

pytestmark = pytest.mark.cuda

BATCH = 128  # RASTER_BATCH in csrc/raster.cu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _soup(n, box, seed, size=12.0):
    """Random screen triangles inside box = (x0, y0, x1, y1): setup rows,
    integer rows (random double-sided flags) and a validity mask (numpy)."""
    rs = np.random.default_rng(seed)
    c = rs.uniform(box[:2], box[2:], (n, 2))
    xy = c[:, None, :] + rs.uniform(-size, size, (n, 3, 2))
    rows = np.zeros((n, raster.SETUP_WIDTH), np.float32)
    rows[:, 0:6] = xy.reshape(n, 6)
    rows[:, 6:9] = rs.uniform(0.0, 1.1, (n, 3))
    rows[:, 9:12] = rs.uniform(0.5, 2.0, (n, 3))
    rows[:, 12:18] = rs.random((n, 6))
    rows[-16:] = rows[:16]  # exact duplicates: equal depths, the first must win
    rows_i = np.zeros((n, raster.SETUP_INT_WIDTH), np.int32)
    rows_i[:, 0] = np.arange(n)
    rows_i[:, 1] = rs.random(n) < 0.3
    return rows, rows_i, np.ones(n, bool)


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
    rows, rows_i, valid = _soup(700, (0, 0, 128, 16), seed=1, size=6.0)
    args = _binned(rows, rows_i, valid, 256, 32, cuda_device)
    counts = torch.diff(args[3])
    assert int(counts.max()) > 3 * BATCH
    _assert_kernel_equals_plain(args)


def test_mostly_empty_tiles(cuda_device):
    rows, rows_i, valid = _soup(40, (500, 150, 640, 200), seed=2)
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
