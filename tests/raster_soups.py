"""Screen-space triangle soups for the tile rasterizer's tests, made with
numpy from a seed. No JAX: the card tests import this module too.

Each maker returns (rows (n, 24) f32, rows_i (n, 8) i32, valid (n,) bool):
setup rows in `ops/raster`'s layout (screen x, y of the three vertices,
depths, 1/w, source barycentrics) and integer rows [id, flags, 0...].
`work_items` lists the tile kernel's work items, as csrc/raster.cu's
`raster_items_kernel` picks them.
"""

import numpy as np
import torch

from gltf_renderer_tpu_torch.ops import raster


def work_items(offsets, list_len: int):
    """The tile kernel's work items, as (tile, lo, hi) int64 tensors: item
    j < n_tiles is tile j's head, its list entries [offsets[j],
    min(offsets[j] + CHUNK, offsets[j + 1])), empty for an empty tile; then
    one item for each list window [e * CHUNK, (e + 1) * CHUNK), e <
    ceil(list_len / CHUNK), that meets a tile's tail (its entries past the
    head): the window's part of the one tail it meets, that of the tile
    holding entry e * CHUNK. Windows that meet no tail are left out (their
    blocks exit at once). CHUNK is `raster.CHUNK`, read from the kernel's
    source."""
    chunk = raster.CHUNK
    off = offsets.long()
    n_tiles = off.shape[0] - 1
    w0 = torch.arange(0, list_len, chunk, dtype=torch.int64, device=off.device)
    tile = torch.clamp(torch.searchsorted(off, w0, right=True) - 1, 0, n_tiles - 1)
    lo = torch.maximum(w0, off[tile] + chunk)
    hi = torch.minimum(w0 + chunk, off[tile + 1])
    meets = lo < hi
    heads = torch.arange(n_tiles, dtype=torch.int64, device=off.device)
    return (torch.cat([heads, tile[meets]]),
            torch.cat([off[:-1], lo[meets]]),
            torch.cat([torch.minimum(off[:-1] + chunk, off[1:]), hi[meets]]))


def _rows(xy, z, rs, double_sided):
    n = xy.shape[0]
    rows = np.zeros((n, raster.SETUP_WIDTH), np.float32)
    rows[:, 0:6] = xy.reshape(n, 6)
    rows[:, 6:9] = z
    rows[:, 9:12] = rs.uniform(0.5, 2.0, (n, 3))
    rows[:, 12:18] = rs.random((n, 6))
    rows_i = np.zeros((n, raster.SETUP_INT_WIDTH), np.int32)
    rows_i[:, 0] = np.arange(n)
    rows_i[:, 1] = double_sided
    return rows, rows_i, np.ones(n, bool)


def soup(n, box, seed, size=12.0):
    """Random triangles around centres inside box = (x0, y0, x1, y1), random
    depths and double-sided flags; the last 16 rows copy the first 16
    (equal depths: the first listed must win)."""
    rs = np.random.default_rng(seed)
    c = rs.uniform(box[:2], box[2:], (n, 2))
    xy = c[:, None, :] + rs.uniform(-size, size, (n, 3, 2))
    rows, rows_i, valid = _rows(xy, rs.uniform(0.0, 1.1, (n, 3)), rs, rs.random(n) < 0.3)
    rows[-16:] = rows[:16]
    return rows, rows_i, valid


def one_tile(n, seed):
    """n small triangles inside the one tile of a 128x16 image, so that the
    tile's list is exactly n entries long."""
    rs = np.random.default_rng(seed)
    c = rs.uniform((4.0, 4.0), (124.0, 12.0), (n, 2))
    xy = c[:, None, :] + rs.uniform(-3.5, 3.5, (n, 3, 2))
    return _rows(xy, rs.uniform(0.05, 0.95, (n, 3)), rs, rs.random(n) < 0.3)


POLE_SIZE = (256, 32)  # 2 x 2 tiles; the pole fills the last one
POLE_FILL = (37, 20)   # filler triangles in tiles 0 and 1; tile 2 stays empty


def pole(n_pole=4000, seed=7):
    """The helmet's pole in miniature: `n_pole` triangles under 3 pixels
    across packed into tile 3 of a 256x32 image, after a few in tiles 0 and
    1, so that the pole's list starts off a work-item boundary and spans
    many items. Depths come from five flat levels (many equal-depth
    overlaps). At every item boundary inside the pole's list, the entry just
    after it copies the entry just before it at the front depth (0.95) and
    both are double-sided: equal depths on both sides of the boundary,
    where the first listed must win. Returns (rows, rows_i, valid, pairs),
    pairs the (first, copy) triangle ids."""
    rs = np.random.default_rng(seed)
    boxes = [(4.0, 4.0, 124.0, 12.0), (132.0, 4.0, 252.0, 12.0)]
    xy = [rs.uniform(b[:2], b[2:], (k, 2))[:, None, :] + rs.uniform(-3.0, 3.0, (k, 3, 2))
          for b, k in zip(boxes, POLE_FILL)]
    centres = rs.uniform((130.0, 18.0), (254.0, 30.0), (n_pole, 2))
    xy.append(centres[:, None, :] + rs.uniform(-1.5, 1.5, (n_pole, 3, 2)))
    xy = np.concatenate(xy)
    n = xy.shape[0]
    z = np.repeat(rs.choice([0.2, 0.35, 0.5, 0.65, 0.8], n)[:, None], 3, 1)
    rows, rows_i, valid = _rows(xy, z, rs, rs.random(n) < 0.3)
    # The pole's triangles are listed in id order from list position
    # sum(POLE_FILL) = id; its head ends CHUNK entries in, its tail windows
    # at multiples of CHUNK.
    start = sum(POLE_FILL)
    cuts = [start + raster.CHUNK] + list(range(
        -(-(start + raster.CHUNK + 1) // raster.CHUNK) * raster.CHUNK, n, raster.CHUNK))
    pairs = [(b - 1, b) for b in cuts]
    for first, copy in pairs:
        # A 3-pixel triangle around a pixel centre: it covers that centre.
        c = np.floor(centres[first - start]) + 0.5
        rows[first, 0:6] = (c + [[-1.5, -1.5], [1.5, -1.5], [0.0, 1.5]]).reshape(6)
        rows[first, 6:9] = 0.95
        rows[copy] = rows[first]
        rows_i[first, 1] = rows_i[copy, 1] = 1
    return rows, rows_i, valid, pairs


def needles(n=600, seed=3, size=(256, 64)):
    """Slivers at the edge of the sub-tile rejection rule: vertices on pixel
    centres or a few ulps off them (box edges within rounding of a centre),
    long edges through rows of pixel centres (edge functions within rounding
    of 0), thickness from 1e-4 to 4 times the rule's area bound E^2 / 1024
    (so some get a rejection box and some do not), a tenth of them reaching
    far outside the image."""
    rs = np.random.default_rng(seed)
    w, h = size
    a = np.floor(rs.uniform((0, 0), (w, h), (n, 2))) + 0.5
    length = rs.uniform(2.0, 200.0, n)
    ang = rs.choice([0.0, 0.5 * np.pi, np.pi, 0.25 * np.pi], n) + np.where(
        rs.random(n) < 0.5, 0.0, rs.uniform(-0.2, 0.2, n))
    d = np.stack([np.cos(ang), np.sin(ang)], 1)
    far = rs.random(n) < 0.1
    length = np.where(far, rs.uniform(1e3, 6e4, n), length)
    b = a + d * length[:, None]
    b = np.where(rs.random((n, 1)) < 0.5, np.floor(b) + 0.5, b)  # on a centre
    thick = length * length / 1024.0 * np.exp(rs.uniform(np.log(1e-4), np.log(4.0), n))
    normal = np.stack([-d[:, 1], d[:, 0]], 1) * (thick / length)[:, None]
    c = b + normal * np.where(rs.random((n, 1)) < 0.5, 1.0, -1.0)
    c = np.where(rs.random((n, 1)) < 0.3, a + normal + d * length[:, None] * 0.5, c)
    xy = np.stack([a, b, c], 1).astype(np.float32)
    ulps = rs.integers(-3, 4, xy.shape).astype(np.float32)
    nudge = rs.random(xy.shape) < 0.4
    xy = np.where(nudge, xy + ulps * np.spacing(np.abs(xy) + 1.0).astype(np.float32), xy)
    return _rows(xy.astype(np.float32), rs.uniform(0.05, 0.95, (n, 3)), rs, rs.random(n) < 0.3)
