"""The tile kernel's decomposition, held on the CPU (no JAX, seconds).

csrc/raster.cu cuts each tile's triangle list into work items of
`raster.CHUNK` entries (`raster_soups.work_items`), tests each triangle only on
the tile pixels of a rectangle around its widened screen box, has each
item offer every pixel a 64-bit key (depth bits, complement of the list
position) and keeps the largest, and computes the barycentrics of the
winner only. These tests hold that algorithm, emulated here in torch with
the kernel's index math and box rule, to `rasterize_tiles_ref` bit for bit,
and check the box rule's soundness on slivers at the edge of its error
bound. The emulation is a test of the algorithm, not a version on any path.
"""

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch.ops import _build, raster

import raster_soups

LIMIT = _build.source_define("raster.cu", "REJECT_LIMIT")


def _binned(rows, rows_i, valid, w, h, pair_cap=1 << 14):
    rows_t, valid_t = torch.from_numpy(rows), torch.from_numpy(valid)
    tri_list, offsets, _ = raster._bin_device(rows_t, valid_t, w, h, pair_cap)
    return (rows_t, torch.from_numpy(rows_i), tri_list, offsets, raster.tile_grid(w, h))


def _corners(r):
    return (r[..., i] for i in range(6))


def _area(r):
    ax, ay, bx, by, cx, cy = _corners(r)
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def _edges(r, px, py):
    ax, ay, bx, by, cx, cy = _corners(r)
    e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
    e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
    e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    return e0, e1, e2


def _inside(area, e0, e1, e2):
    pos = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
    neg = (e0 <= 0.0) & (e1 <= 0.0) & (e2 <= 0.0)
    return torch.where(area > 0.0, pos, neg)


def _boxes(r):
    """The rejection box of each row, as csrc/raster.cu's `stage` makes it
    for a live triangle: the screen box widened by E/256 + R/2^22 where
    |area| >= E^2 / 1024 and E, R <= 2^22 (E the extent, R the largest
    |coordinate|); unbounded otherwise. Returns (lo_x, hi_x, lo_y, hi_y,
    given a box)."""
    ax, ay, bx, by, cx, cy = _corners(r)
    area = _area(r)
    x_min = torch.minimum(torch.minimum(ax, bx), cx)
    x_max = torch.maximum(torch.maximum(ax, bx), cx)
    y_min = torch.minimum(torch.minimum(ay, by), cy)
    y_max = torch.maximum(torch.maximum(ay, by), cy)
    ext = torch.maximum(x_max - x_min, y_max - y_min)
    reach = torch.stack([x_min.abs(), x_max.abs(), y_min.abs(), y_max.abs()]).amax(0)
    ok = (ext <= LIMIT) & (reach <= LIMIT) & (area.abs() >= ext * ext * (1.0 / 1024.0))
    m = ext * (1.0 / 256.0) + reach * (1.0 / LIMIT)
    inf = torch.full_like(ax, float("inf"))
    return (torch.where(ok, x_min - m, -inf), torch.where(ok, x_max + m, inf),
            torch.where(ok, y_min - m, -inf), torch.where(ok, y_max + m, inf), ok)


def _rects(r, x0, y0):
    """The kernel's rectangle of tile pixels (first and last column and row)
    whose centres the rejection box may hold: floor / ceil of the box's
    bounds less the first centre, clamped to the tile."""
    lo_x, hi_x, lo_y, hi_y, _ = _boxes(r)
    fx, fy = x0 + 0.5, y0 + 0.5
    c0 = torch.clamp(torch.floor(lo_x - fx), min=-1.0).clamp(min=0)
    c1 = torch.clamp(torch.ceil(hi_x - fx), max=float(raster.TILE_W)).clamp(max=raster.TILE_W - 1)
    r0 = torch.clamp(torch.floor(lo_y - fy), min=-1.0).clamp(min=0)
    r1 = torch.clamp(torch.ceil(hi_y - fy), max=float(raster.TILE_H)).clamp(max=raster.TILE_H - 1)
    return c0, c1, r0, r1


def _emulate(rows, rows_i, tri_list, offsets, tiles, cull_sign):
    """The kernel's algorithm in torch: per work item, each pixel's best
    (z, list position) over the item's entries in list order, each entry
    tested only inside its rectangle; the largest key per pixel over all
    items (the kernel also takes the largest key within an item); the
    winner's tri, u and v from its row."""
    tiles_x, tiles_y = tiles
    img_w, img_h = tiles_x * raster.TILE_W, tiles_y * raster.TILE_H
    tile, lo, hi = raster_soups.work_items(offsets, tri_list.shape[0])
    x0 = ((tile % tiles_x) * raster.TILE_W).to(torch.float32)[:, None, None]
    y0 = ((tile // tiles_x) * raster.TILE_H).to(torch.float32)[:, None, None]
    col = torch.arange(raster.TILE_W, dtype=torch.float32)
    row = torch.arange(raster.TILE_H, dtype=torch.float32)[:, None]
    px, py = (x0 + col) + 0.5, (y0 + row) + 0.5
    best_z = torch.zeros((tile.shape[0], raster.TILE_H, raster.TILE_W))
    best_pos = torch.full_like(best_z, -1, dtype=torch.int64)
    for k in range(raster.CHUNK):
        pos = lo + k
        slot = tri_list[torch.clamp(pos, max=tri_list.shape[0] - 1)].long()
        r = rows[slot][:, None, None, :]
        area = _area(r)
        e0, e1, e2 = _edges(r, px, py)
        inside = _inside(area, e0, e1, e2)
        if cull_sign:
            side = area > 0.0 if cull_sign > 0 else area <= 0.0
            inside = inside & ~(side & ((rows_i[slot, 1] & 1) == 0)[:, None, None])
        c0, c1, r0, r1 = _rects(r, x0, y0)
        kept = (col >= c0) & (col <= c1) & (row >= r0) & (row <= r1)
        inv_area = 1.0 / area
        z = e0 * inv_area * r[..., 6] + e1 * inv_area * r[..., 7] + e2 * inv_area * r[..., 8]
        take = ((pos < hi)[:, None, None] & kept & inside & (area.abs() > 1e-12)
                & (z > best_z) & (z <= 1.0) & (z >= 0.0))
        best_z = torch.where(take, z, best_z)
        best_pos = torch.where(take, pos[:, None, None], best_pos)

    key = torch.where(best_pos >= 0,
                      (best_z.view(torch.int32).long() << 32) | (0xFFFFFFFF - best_pos),
                      torch.zeros_like(best_pos))
    o = ((y0 + row).long() * img_w + (x0 + col).long()).expand_as(key)
    keys = torch.zeros(img_h * img_w, dtype=torch.int64).scatter_reduce(
        0, o.reshape(-1), key.reshape(-1), "amax").reshape(img_h, img_w)

    won = keys != 0
    z = (keys >> 32).to(torch.int32).view(torch.float32)
    slot = tri_list[torch.where(won, 0xFFFFFFFF - (keys & 0xFFFFFFFF), 0)].long()
    r = rows[slot]
    ipx = torch.arange(img_w, dtype=torch.float32) + 0.5
    ipy = torch.arange(img_h, dtype=torch.float32)[:, None] + 0.5
    e0, e1, e2 = _edges(r, ipx, ipy)
    inv_area = 1.0 / _area(r)
    pw0 = e0 * inv_area * r[..., 9]
    pw1 = e1 * inv_area * r[..., 10]
    pw2 = e2 * inv_area * r[..., 11]
    denom = pw0 + pw1 + pw2
    inv_denom = torch.where(denom.abs() > 1e-20, 1.0 / denom, torch.zeros_like(denom))
    u = (pw0 * r[..., 12] + pw1 * r[..., 14] + pw2 * r[..., 16]) * inv_denom
    v = (pw0 * r[..., 13] + pw1 * r[..., 15] + pw2 * r[..., 17]) * inv_denom
    zero = torch.zeros_like(u)
    tri = torch.where(won, rows_i[slot, 0], torch.full_like(rows_i[slot, 0], -1))
    return z, tri, torch.where(won, u, zero), torch.where(won, v, zero)


def _degenerate(seed=5):
    """A soup with zero-area, collinear and near-1e-12-area triangles mixed in."""
    rows, rows_i, valid = raster_soups.soup(160, (0, 0, 256, 32), seed, size=8.0)
    rows[0:10, 2:4] = rows[0:10, 0:2]                               # a == b
    rows[10:20, 4:6] = 2.0 * rows[10:20, 2:4] - rows[10:20, 0:2]    # collinear
    tiny = rows[20:40, 0:2].copy()
    rows[20:40, 2:6] = np.tile(tiny, 2) + np.float32(1e-6) * np.array(
        [1.0, 0.0, 0.0, 1.0], np.float32) * np.linspace(0.5, 2.0, 20, dtype=np.float32)[:, None]
    return rows, rows_i, valid


CASES = {
    "soup": lambda: _binned(*raster_soups.soup(300, (0, 0, 256, 48), 1, size=10.0), 256, 48),
    "pole": lambda: _binned(*raster_soups.pole()[:3], *raster_soups.POLE_SIZE),
    "needles": lambda: _binned(*raster_soups.needles(), 256, 64),
    "degenerate": lambda: _binned(*_degenerate(), 256, 32),
    "one_item": lambda: _binned(*raster_soups.one_tile(raster.CHUNK, 9), 128, 16),
    "one_item_and_one": lambda: _binned(*raster_soups.one_tile(raster.CHUNK + 1, 9), 128, 16),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return request.param, CASES[request.param]()


@pytest.mark.parametrize("cull_sign", [-1, 0, 1])
def test_item_merge_equals_plain(case, cull_sign):
    name, args = case
    want = raster.rasterize_tiles_ref(*args, cull_sign=cull_sign)
    got = _emulate(*args, cull_sign=cull_sign)
    for n, g, w in zip(("z", "tri", "u", "v"), got, want):
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), f"{name}: {n} differs"
    assert (want[1] >= 0).any()


def test_pole_spans_items_and_the_first_of_equal_depths_wins():
    rows, rows_i, valid, pairs = raster_soups.pole()
    args = _binned(rows, rows_i, valid, *raster_soups.POLE_SIZE)
    counts = torch.diff(args[3])
    assert counts.tolist()[:3] == [raster_soups.POLE_FILL[0], raster_soups.POLE_FILL[1], 0]
    assert int(counts[3]) > 30 * raster.CHUNK
    tile, lo, hi = raster_soups.work_items(args[3], args[2].shape[0])
    starts = set(lo[tile == 3].tolist())
    for first, copy in pairs:
        assert int(args[2][copy]) == copy and copy in starts  # an item starts at the copy
    tri = raster.rasterize_tiles_ref(*args, cull_sign=0)[1]
    won = set(torch.unique(tri).tolist())
    assert not won & {copy for _, copy in pairs}
    assert len(won & {first for first, _ in pairs}) >= 0.9 * len(pairs)


@pytest.mark.parametrize("counts", [
    [0, 1, 63, 64, 65, 127, 128, 129, 0, 0, 1000, 5],
    [200, 0, 0, 0, 64],
    [0, 0, 0],
    [3 * 64 + 17] * 7,
])
def test_work_items_cover_every_entry_once_in_list_order(counts):
    n_tiles = len(counts)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    total = int(offsets[-1])
    for list_len in (total, total + 1, total + raster.CHUNK + 3):
        tile, lo, hi = raster_soups.work_items(offsets, list_len)
        assert tile.shape[0] <= n_tiles + -(-list_len // raster.CHUNK)   # the grid
        assert torch.equal(tile[:n_tiles], torch.arange(n_tiles))
        off = offsets.long()
        assert bool(((off[tile] <= lo) & (lo <= hi) & (hi <= off[tile + 1])).all())
        assert bool((hi - lo <= raster.CHUNK).all())
        covered = torch.zeros(max(list_len, 1), dtype=torch.int64)
        for a, b in zip(lo.tolist(), hi.tolist()):
            covered[a:b] += 1
        assert covered[:total].eq(1).all() and covered[total:].eq(0).all()
        for t in range(n_tiles):   # a tile's items, by start, tile its list in order
            mine = sorted(zip(lo[tile == t].tolist(), hi[tile == t].tolist()))
            mine = [(a, b) for a, b in mine if b > a]
            ends = [int(off[t])] + [b for _, b in mine]
            assert [a for a, _ in mine] == ends[:-1] and ends[-1] == int(off[t + 1])


def test_box_rule_never_rejects_a_pixel_the_plain_test_accepts():
    """Every pixel centre of a 256x64 image that passes the plain version's
    inside test for a live triangle lies in that triangle's rejection box,
    on slivers built at the edge of the rule's error bound and on soups."""
    rows = np.concatenate([raster_soups.needles()[0], raster_soups.needles(seed=4)[0],
                           raster_soups.soup(400, (0, 0, 256, 64), 2, size=20.0)[0],
                           _degenerate()[0]])
    r = torch.from_numpy(rows)
    px = torch.arange(256, dtype=torch.float32) + 0.5
    py = torch.arange(64, dtype=torch.float32)[:, None] + 0.5
    boxed = edge_hits = 0
    outside = {True: 0, False: 0}  # pixels inside, but outside the plain box
    for part in torch.split(r, 128):
        q = part[:, None, None, :]
        area = _area(q)
        inside = _inside(area, *_edges(q, px, py)) & (area.abs() > 1e-12)
        lo_x, hi_x, lo_y, hi_y, ok = _boxes(q)
        in_box = (px >= lo_x) & (px <= hi_x) & (py >= lo_y) & (py <= hi_y)
        assert not bool((inside & ~in_box).any())
        boxed += int(ok.sum())
        ax, ay, bx, by, cx, cy = _corners(q)
        x_min = torch.minimum(torch.minimum(ax, bx), cx)
        x_max = torch.maximum(torch.maximum(ax, bx), cx)
        y_min = torch.minimum(torch.minimum(ay, by), cy)
        y_max = torch.maximum(torch.maximum(ay, by), cy)
        on_edge = (px == x_min) | (px == x_max) | (py == y_min) | (py == y_max)
        edge_hits += int((inside & on_edge).sum())
        out = inside & ((px < x_min) | (px > x_max) | (py < y_min) | (py > y_max))
        outside[True] += int((out & ok).sum())
        outside[False] += int((out & ~ok).sum())
    # Both kinds of triangle are present; pixel centres on a box edge pass
    # the inclusive test; and rounding puts inside pixels outside the plain
    # box, both of triangles that get a widened box (the margin is needed)
    # and of those too thin for one (the area test is needed).
    assert 0 < boxed < r.shape[0]
    assert edge_hits > 0
    assert outside[True] > 0 and outside[False] > 0


def test_kernel_constants_are_read_from_its_source():
    """`raster.CHUNK` and this file's LIMIT are the numbers csrc/raster.cu
    #defines (an int and a float literal with an f suffix); a name the
    source does not define raises."""
    assert raster.CHUNK == _build.source_define("raster.cu", "RASTER_CHUNK")
    assert isinstance(raster.CHUNK, int) and raster.CHUNK > 0
    assert isinstance(LIMIT, float) and LIMIT > 0.0
    with pytest.raises(KeyError, match="RASTER_NOTHING"):
        _build.source_define("raster.cu", "RASTER_NOTHING")
