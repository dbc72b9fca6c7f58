"""Tile-binned rasterizer: the raster backend's `tiled` visibility.

Port of gltf_renderer_tpu/ops/pallas_raster.py. The device path
(`rasterize_device`, which the renderer runs) has four stages, all on the
tensors' device with no host sync:

1. `_setup_device`: clip transform and (T, 24) setup rows for triangles
   wholly in front of the near plane, plus the keep / near-crossing masks;
2. `_clip_near_device` + `_screen_rows`: Sutherland-Hodgman clip of the
   first CLIP_CAP near-plane crossers; each piece's vertices carry their
   barycentrics in the SOURCE triangle;
3. `_bin_device`: (triangle, 16x128 tile) pair expansion, one stable sort
   by tile, CSR offsets by searchsorted. Pairs past `pair_cap` and crossers
   past CLIP_CAP are dropped, as the JAX package drops them;
4. `rasterize_tiles`: the per-tile z-buffer. A CPU tensor goes to the plain
   version `rasterize_tiles_ref`; a CUDA tensor goes to the CUDA kernel
   (csrc/raster.cu), or the call raises. There is no fallback between them.
   The kernel cuts each tile's list into work items of CHUNK entries and
   merges a tile's items through a per-pixel 64-bit key buffer that the
   wrapper allocates.

`KERNEL_LAUNCHES` and `REFERENCE_CALLS` count kernel launches and
plain-version calls, so a run can show which one it used.

Setup row layout: [x0, y0, x1, y1, x2, y2, z0, z1, z2, iw0, iw1, iw2,
u0, v0, u1, v1, u2, v2, 0...]: screen coordinates, reversed-Z NDC depth,
1/clip_w, and each setup vertex's barycentrics in the original triangle.
Integer rows: [triangle id, flags (bit 0: double-sided), 0...].

The host-binned path (`rasterize`) is the JAX module's first pipeline,
kept as a public function: `build_setup` runs `_setup_device` and copies
one (T, 6) summary to the host, clips the near-plane crossers there
(`_clip_near_host`, numpy, every crosser), and `bin_triangles` builds the
CSR tile lists in numpy; then `rasterize_tiles` runs as above. It has no
caps: every pair and every crosser is kept.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from gltf_renderer_tpu_torch.ops import _build

TILE_H = 16
TILE_W = 128
SETUP_WIDTH = 24
SETUP_INT_WIDTH = 8
NEAR_EPS = 1e-6
CLIP_CAP = 1024  # near-plane crossers clipped per frame; later ones are dropped

KERNEL_LAUNCHES = 0
REFERENCE_CALLS = 0

_SOURCE = "raster.cu"
CHUNK = _build.source_define(_SOURCE, "RASTER_CHUNK")  # list entries of one work item
_ARGTYPES = [_build.VP] * 4 + [_build.CI] * 4 + [_build.VP] * 6


def default_pair_cap(n_tris: int) -> int:
    """The JAX package's pair-list length: the power of two above 4x the
    triangle count, at least 2^16."""
    return max(1 << 16, 1 << int(np.ceil(np.log2(max(4 * n_tris, 1)))))


def _clip_transform(p, m):
    """(V, 3) world positions -> (V, 4) clip coordinates, p @ m[:, :3].T +
    m[:, 3], each dot product summed in index order so that every device
    rounds it the same way."""
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    return x * m[:, 0] + y * m[:, 1] + z * m[:, 2] + m[:, 3]


def _to_screen(clip, width: int, height: int):
    """Clip (..., 4) -> screen x, y, reversed-Z depth and 1/w."""
    w = clip[..., 3]
    safe_w = torch.where(torch.abs(w) > 1e-9, w, torch.full_like(w, 1e-9))
    sx = ((clip[..., 0] / safe_w) + 1.0) * 0.5 * width
    sy = (-(clip[..., 1] / safe_w) + 1.0) * 0.5 * height
    sz = clip[..., 2] / safe_w
    iw = 1.0 / safe_w
    return sx, sy, sz, iw


def _setup_device(world_position, tri_vertex, world_to_clip, width: int, height: int):
    """Clip transform + setup rows for every triangle (only those wholly in
    front of the near plane are kept). Returns (rows (T, 24), clip (V, 4),
    keep (T,), cross (T,))."""
    clip = _clip_transform(world_position, world_to_clip)
    sx, sy, sz, iw = _to_screen(clip, width, height)
    tv = tri_vertex.long()
    i0, i1, i2 = tv[:, 0], tv[:, 1], tv[:, 2]
    t = tv.shape[0]
    n_behind = (clip[:, 3][tv] <= NEAR_EPS).sum(1)
    keep = n_behind == 0
    cross = (n_behind > 0) & (n_behind < 3)
    zf = torch.zeros(t, dtype=torch.float32, device=clip.device)
    onef = torch.ones_like(zf)
    rows = torch.stack(
        [sx[i0], sy[i0], sx[i1], sy[i1], sx[i2], sy[i2],
         sz[i0], sz[i1], sz[i2], iw[i0], iw[i1], iw[i2],
         zf, zf, onef, zf, zf, onef] + [zf] * (SETUP_WIDTH - 18), 1)
    return rows, clip, keep, cross


def _clip_near_device(clip, tri_vertex, cross, clip_cap: int):
    """Vectorised Sutherland-Hodgman clip against w = NEAR_EPS.

    The first `clip_cap` crossers (in triangle order, by a stable sort) are
    clipped; a crosser with one vertex in front yields one piece, with two
    in front two (a quad fan). Returns (verts (2K, 3, 4) clip space, bary
    (2K, 3, 3) in the SOURCE triangle, src (2K,) source ids, valid (2K,))."""
    key = torch.where(cross, 0, 1).to(torch.int32)
    cand = torch.sort(key, stable=True).indices[:clip_cap]
    cand_valid = cross[cand]
    vs = clip[tri_vertex[cand].long()]                      # (K, 3, 4)
    inside = vs[..., 3] > NEAR_EPS
    n_in = inside.sum(-1)
    # Rotate so v0 is the lone vertex (the inside one when one is inside,
    # the outside one when two are); a cyclic rotation keeps the winding.
    r_in = torch.argmax(inside.to(torch.int32), -1)
    r_out = torch.argmax((~inside).to(torch.int32), -1)
    r = torch.where(n_in == 1, r_in, r_out)
    eye = torch.eye(3, dtype=torch.float32, device=clip.device)

    def take(k):
        j = (r + k) % 3
        v = torch.gather(vs, 1, j[:, None, None].expand(-1, 1, 4))[:, 0]
        return v, eye[j]

    va, ba = take(0)
    vb, bb = take(1)
    vc, bc = take(2)

    def isect(p, q, bp, bq):
        dw = q[:, 3] - p[:, 3]
        s = (NEAR_EPS - p[:, 3]) / torch.where(torch.abs(dw) > 1e-20, dw,
                                               torch.full_like(dw, 1e-20))
        s = s[:, None]
        return p + s * (q - p), bp + s * (bq - bp)

    iab, b_iab = isect(va, vb, ba, bb)
    iac, b_iac = isect(va, vc, ba, bc)
    one_in = (n_in == 1)[:, None, None]
    # One inside (a):  piece 1 = (a, iab, iac), no piece 2.
    # Two inside (a outside): quad (iab, b, c, iac) -> (iab, b, c), (iab, c, iac).
    t1_v = torch.where(one_in, torch.stack([va, iab, iac], 1), torch.stack([iab, vb, vc], 1))
    t1_b = torch.where(one_in, torch.stack([ba, b_iab, b_iac], 1),
                       torch.stack([b_iab, bb, bc], 1))
    t2_v = torch.stack([iab, vc, iac], 1)
    t2_b = torch.stack([b_iab, bc, b_iac], 1)
    verts = torch.cat([t1_v, t2_v])
    bary = torch.cat([t1_b, t2_b])
    src = torch.cat([cand, cand]).to(torch.int32)
    valid = torch.cat([cand_valid & (n_in >= 1), cand_valid & (n_in == 2)])
    return verts, bary, src, valid


def _screen_rows(verts, bary, width: int, height: int):
    """Clip-space (K, 3, 4) pieces + source barycentrics -> (K, 24) rows."""
    sx, sy, sz, iw = _to_screen(verts, width, height)
    k = verts.shape[0]
    cols = [sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1], sx[:, 2], sy[:, 2],
            sz[:, 0], sz[:, 1], sz[:, 2], iw[:, 0], iw[:, 1], iw[:, 2],
            bary[:, 0, 1], bary[:, 0, 2], bary[:, 1, 1], bary[:, 1, 2],
            bary[:, 2, 1], bary[:, 2, 2]]
    zeros = torch.zeros(k, dtype=torch.float32, device=verts.device)
    return torch.stack(cols + [zeros] * (SETUP_WIDTH - 18), 1)


def tile_grid(width: int, height: int) -> Tuple[int, int]:
    """(tiles_x, tiles_y) of the 16x128 tile grid covering the image."""
    return -(-width // TILE_W), -(-height // TILE_H)


def _bin_device(rows, valid, width: int, height: int, pair_cap: int):
    """(triangle, tile) pairs -> (tri_list (pair_cap,) i32 sorted stably by
    tile, offsets (n_tiles + 1,) i32 CSR starts, n_pairs () i64 before the
    cap). Entries past offsets[-1] are padding (their tile is n_tiles)."""
    tiles_x, tiles_y = tile_grid(width, height)
    n_tiles = tiles_x * tiles_y
    dev = rows.device
    sx = rows[:, 0:6:2]
    sy = rows[:, 1:6:2]
    x0 = sx.amin(1)
    x1 = sx.amax(1)
    y0 = sy.amin(1)
    y1 = sy.amax(1)
    valid = valid & (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height)

    def tile_of(c, size, n):
        # Clamp in float before the integer conversion: the same tiles as a
        # saturating conversion followed by the clip, for any magnitude.
        return torch.clamp(torch.floor(c / size), 0, n - 1).to(torch.int64)

    tx0 = tile_of(x0, TILE_W, tiles_x)
    tx1 = tile_of(x1, TILE_W, tiles_x)
    ty0 = tile_of(y0, TILE_H, tiles_y)
    ty1 = tile_of(y1, TILE_H, tiles_y)
    zero = torch.zeros_like(tx0)
    nx = torch.where(valid, tx1 - tx0 + 1, zero)
    ny = torch.where(valid, ty1 - ty0 + 1, zero)
    counts = nx * ny
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    # jnp.repeat(arange(t), counts, total_repeat_length=pair_cap): entry j
    # belongs to the last triangle whose start is <= j; past the total it
    # repeats the last triangle (masked by `ok` below).
    j = torch.arange(pair_cap, dtype=torch.int64, device=dev)
    tri_rep = torch.searchsorted(starts, j, right=True) - 1
    local = j - starts[tri_rep]
    nxr = torch.clamp(nx[tri_rep], min=1)
    ok = (local >= 0) & (local < counts[tri_rep]) & (j < ends[-1])
    tile = (ty0[tri_rep] + local // nxr) * tiles_x + (tx0[tri_rep] + local % nxr)
    tile = torch.where(ok, tile, torch.full_like(tile, n_tiles))
    tile_s, perm = torch.sort(tile, stable=True)
    tri_list = tri_rep[perm].to(torch.int32)
    offsets = torch.searchsorted(
        tile_s, torch.arange(n_tiles + 1, dtype=torch.int64, device=dev)).to(torch.int32)
    return tri_list, offsets, ends[-1]


class TileInputs(NamedTuple):
    """Everything `rasterize_tiles` reads for one view, and the counts the
    caps bound."""

    rows: Any       # (T', 24) f32 setup rows, T' = T + 2 * min(T, clip_cap)
    rows_i: Any     # (T', 8) i32 [triangle id, flags, 0...]
    tri_list: Any   # (pair_cap,) i32
    offsets: Any    # (n_tiles + 1,) i32
    tiles: Tuple[int, int]
    n_pairs: Any    # () i64 pairs before the pair cap
    n_cross: Any    # () i64 near-plane crossers before the clip cap
    pair_cap: int
    clip_cap: int


def prepare_tiles(world_position, tri_vertex, world_to_clip, width: int, height: int,
                  double_sided=None, pair_cap: int = 0,
                  clip_cap: int = CLIP_CAP) -> TileInputs:
    """Stages 1-3: setup, near clip and binning on the tensors' device."""
    dev = world_position.device
    t = tri_vertex.shape[0]
    if pair_cap <= 0:
        pair_cap = default_pair_cap(t)
    m = torch.as_tensor(np.asarray(world_to_clip, np.float32), device=dev)
    rows_d, clip, keep, cross = _setup_device(world_position, tri_vertex, m, width, height)
    ds = (torch.zeros(t, dtype=torch.int32, device=dev) if double_sided is None
          else torch.as_tensor(double_sided, device=dev).to(torch.int32))
    ids = torch.arange(t, dtype=torch.int32, device=dev)
    zi = torch.zeros(t, dtype=torch.int32, device=dev)
    rows_i = torch.stack([ids, ds] + [zi] * (SETUP_INT_WIDTH - 2), 1)

    verts, bary, src, cvalid = _clip_near_device(clip, tri_vertex, cross, clip_cap)
    rows_ext = _screen_rows(verts, bary, width, height)
    zi2 = torch.zeros(src.shape[0], dtype=torch.int32, device=dev)
    rows_i_ext = torch.stack([src, ds[src.long()]] + [zi2] * (SETUP_INT_WIDTH - 2), 1)

    rows = torch.cat([rows_d, rows_ext])
    rows_i = torch.cat([rows_i, rows_i_ext])
    valid = torch.cat([keep, cvalid])
    tri_list, offsets, n_pairs = _bin_device(rows, valid, width, height, pair_cap)
    return TileInputs(rows=rows, rows_i=rows_i, tri_list=tri_list, offsets=offsets,
                      tiles=tile_grid(width, height), n_pairs=n_pairs,
                      n_cross=cross.sum(), pair_cap=pair_cap, clip_cap=clip_cap)


def rasterize_device(world_position, tri_vertex, world_to_clip, width: int, height: int,
                     double_sided=None, cull_sign: int = 1, pair_cap: int = 0,
                     clip_cap: int = CLIP_CAP):
    """The whole visibility stage on the tensors' device. world_position
    (V, 3) f32, tri_vertex (T, 3) int, world_to_clip (4, 4) f32 host matrix.
    Returns (z, tri, u, v), each (height, width)."""
    ins = prepare_tiles(world_position, tri_vertex, world_to_clip, width, height,
                        double_sided=double_sided, pair_cap=pair_cap, clip_cap=clip_cap)
    z, tri, u, v = rasterize_tiles(ins.rows, ins.rows_i, ins.tri_list, ins.offsets,
                                   ins.tiles, cull_sign=cull_sign)
    return z[:height, :width], tri[:height, :width], u[:height, :width], v[:height, :width]


# ---------------------------------------------------------------------------
# The host-binned path
# ---------------------------------------------------------------------------

class RasterSetup(NamedTuple):
    rows: Any                # (T', 24) f32 setup rows on the device
    rows_i: Any              # (T', 8) i32 [triangle id, flags, 0...] on the device
    valid: np.ndarray        # (T',) bool host mask (wholly in front, or a clipped piece)
    screen_aabb: np.ndarray  # (T', 4) f32 host [x0, y0, x1, y1]


def _clip_near_host(clip, tri_vertex, keep_mask, cross_mask):
    """Sutherland-Hodgman clip of the `cross_mask` triangles against
    w = NEAR_EPS, in numpy. Returns (clip_verts (M, 3, 4), bary (M, 3, 3),
    src (M,)): up to 2 triangles a crosser, each vertex carrying its
    barycentrics in the SOURCE triangle."""
    idx = np.nonzero(cross_mask)[0]
    out_v, out_b, out_src = [], [], []
    eye = np.eye(3, dtype=np.float32)
    for t in idx:
        vs = clip[tri_vertex[t]]                     # (3, 4)
        polys_v = []
        polys_b = []
        for k in range(3):
            a, b = vs[k], vs[(k + 1) % 3]
            ba, bb = eye[k], eye[(k + 1) % 3]
            ina, inb = a[3] > NEAR_EPS, b[3] > NEAR_EPS
            if ina:
                polys_v.append(a)
                polys_b.append(ba)
            if ina != inb:
                s = (NEAR_EPS - a[3]) / (b[3] - a[3])
                polys_v.append(a + s * (b - a))
                polys_b.append(ba + s * (bb - ba))
        if len(polys_v) < 3:
            continue
        for k in range(1, len(polys_v) - 1):
            out_v.append([polys_v[0], polys_v[k], polys_v[k + 1]])
            out_b.append([polys_b[0], polys_b[k], polys_b[k + 1]])
            out_src.append(t)
    if not out_v:
        return (np.zeros((0, 3, 4), np.float32), np.zeros((0, 3, 3), np.float32),
                np.zeros(0, np.int64))
    return (np.asarray(out_v, np.float32), np.asarray(out_b, np.float32),
            np.asarray(out_src, np.int64))


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_setup(world_position, tri_vertex, world_to_clip, width: int, height: int,
                double_sided=None) -> RasterSetup:
    """Setup rows on the tensors' device for the triangles wholly in front
    of the near plane, then one host copy of the (T, 6) summary (screen
    box, keep, cross); the crossers are clipped on the host and their
    pieces' rows appended. world_to_clip (4, 4) f32 host matrix."""
    dev = world_position.device
    tv = _host(tri_vertex)
    t = tv.shape[0]
    m = torch.as_tensor(np.asarray(world_to_clip, np.float32), device=dev)
    rows_d, clip_d, keep_d, cross_d = _setup_device(world_position, tri_vertex, m, width, height)
    sx, sy = rows_d[:, 0:6:2], rows_d[:, 1:6:2]
    summary = _host(torch.stack([sx.amin(1), sy.amin(1), sx.amax(1), sy.amax(1),
                                 keep_d.to(torch.float32), cross_d.to(torch.float32)], 1))
    aabb = summary[:, 0:4]
    keep = summary[:, 4] > 0.5
    cross = summary[:, 5] > 0.5

    ds = (_host(double_sided).astype(np.int32) if double_sided is not None
          else np.zeros(t, np.int32))
    rows_i = np.stack([np.arange(t, dtype=np.int32), ds] + [np.zeros(t, np.int32)] * 6,
                      1).astype(np.int32)
    rows = rows_d
    valid = keep
    if cross.any():
        cv, cb, cs = _clip_near_host(_host(clip_d), tv, keep, cross)
        w = cv[..., 3]
        safe_w = np.where(np.abs(w) > 1e-9, w, 1e-9)
        px = ((cv[..., 0] / safe_w) + 1.0) * 0.5 * width
        py = (-(cv[..., 1] / safe_w) + 1.0) * 0.5 * height
        pz = cv[..., 2] / safe_w
        iw = 1.0 / safe_w
        extra = np.concatenate(
            [np.stack([px[:, 0], py[:, 0], px[:, 1], py[:, 1], px[:, 2], py[:, 2],
                       pz[:, 0], pz[:, 1], pz[:, 2], iw[:, 0], iw[:, 1], iw[:, 2]], 1),
             cb[:, 0, 1:3].reshape(-1, 2), cb[:, 1, 1:3].reshape(-1, 2),
             cb[:, 2, 1:3].reshape(-1, 2),
             np.zeros((len(cs), SETUP_WIDTH - 18), np.float32)], axis=1).astype(np.float32)
        rows = torch.cat([rows_d, torch.as_tensor(extra, device=dev)])
        zi = np.zeros(len(cs), np.int32)
        rows_i = np.concatenate([rows_i, np.stack([cs.astype(np.int32), ds[cs]] + [zi] * 6, 1)])
        aabb = np.concatenate([aabb, np.stack([px.min(1), py.min(1), px.max(1), py.max(1)],
                                              1)]).astype(np.float32)
        valid = np.concatenate([keep, np.ones(len(cs), bool)])
    return RasterSetup(rows=rows, rows_i=torch.as_tensor(rows_i, device=dev), valid=valid,
                       screen_aabb=aabb)


def bin_triangles(setup: RasterSetup, width: int, height: int):
    """The CSR tile lists, in numpy: (tri_list (pairs,) i32 setup-row ids
    sorted stably by tile, offsets (n_tiles + 1,) i32, (tiles_x, tiles_y))."""
    tiles_x, tiles_y = tile_grid(width, height)
    aabb = setup.screen_aabb
    valid = setup.valid.copy()
    # Degenerate / off-screen rejection.
    valid &= (aabb[:, 2] >= 0) & (aabb[:, 0] < width)
    valid &= (aabb[:, 3] >= 0) & (aabb[:, 1] < height)

    tx0 = np.clip((aabb[:, 0] // TILE_W).astype(np.int64), 0, tiles_x - 1)
    tx1 = np.clip((aabb[:, 2] // TILE_W).astype(np.int64), 0, tiles_x - 1)
    ty0 = np.clip((aabb[:, 1] // TILE_H).astype(np.int64), 0, tiles_y - 1)
    ty1 = np.clip((aabb[:, 3] // TILE_H).astype(np.int64), 0, tiles_y - 1)
    nx = np.where(valid, tx1 - tx0 + 1, 0)
    ny = np.where(valid, ty1 - ty0 + 1, 0)
    counts = nx * ny
    total = int(counts.sum())
    tri_rep = np.repeat(np.arange(len(counts)), counts)
    # Each pair's tile within its triangle's box.
    local = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    nx_rep = np.repeat(nx, counts)
    lx = local % np.maximum(nx_rep, 1)
    ly = local // np.maximum(nx_rep, 1)
    tile_id = (np.repeat(ty0, counts) + ly) * tiles_x + np.repeat(tx0, counts) + lx

    order = np.argsort(tile_id, kind="stable")
    offsets = np.zeros(tiles_x * tiles_y + 1, np.int64)
    np.add.at(offsets, tile_id[order] + 1, 1)
    return (tri_rep[order].astype(np.int32), np.cumsum(offsets).astype(np.int32),
            (tiles_x, tiles_y))


def rasterize(world_position, tri_vertex, world_to_clip, width: int, height: int,
              double_sided=None, cull_backfaces: bool = True):
    """The host-binned pipeline: `build_setup`, `bin_triangles`, then
    `rasterize_tiles` on the tensors' device. Returns (z, tri, u, v), each
    (height, width)."""
    setup = build_setup(world_position, tri_vertex, world_to_clip, width, height, double_sided)
    flat, offsets, tiles = bin_triangles(setup, width, height)
    if len(flat) == 0:
        flat = np.zeros(1, np.int32)
    dev = setup.rows.device
    z, tri, u, v = rasterize_tiles(setup.rows, setup.rows_i, torch.as_tensor(flat, device=dev),
                                   torch.as_tensor(offsets, device=dev), tiles,
                                   cull_sign=1 if cull_backfaces else 0)
    return z[:height, :width], tri[:height, :width], u[:height, :width], v[:height, :width]


# ---------------------------------------------------------------------------
# Stage 4: the per-tile z-buffer
# ---------------------------------------------------------------------------

def _check_tile_inputs(rows, rows_i, tri_list, offsets, tiles, cull_sign):
    tiles_x, tiles_y = tiles
    want = [
        ("rows", rows, torch.float32, (None, SETUP_WIDTH)),
        ("rows_i", rows_i, torch.int32, (rows.shape[0], SETUP_INT_WIDTH)),
        ("tri_list", tri_list, torch.int32, (None,)),
        ("offsets", offsets, torch.int32, (tiles_x * tiles_y + 1,)),
    ]
    for name, x, dtype, shape in want:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, x.shape)):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != rows.device:
            raise ValueError(f"{name} is on {x.device}, rows on {rows.device}")
    if cull_sign not in (-1, 0, 1):
        raise ValueError(f"cull_sign must be -1, 0 or 1, got {cull_sign}")
    if tiles_x <= 0 or tiles_y <= 0:
        raise ValueError(f"empty tile grid {tiles}")


def rasterize_tiles(rows, rows_i, tri_list, offsets, tiles: Tuple[int, int],
                    cull_sign: int = 1):
    """Rasterize every 16x128 tile's triangle list. Returns (z, tri, u, v),
    each (tiles_y * 16, tiles_x * 128): reversed-Z depth (clear 0), the
    winning triangle's `rows_i[:, 0]` (clear -1) and its perspective-correct
    barycentrics in the source triangle (clear 0).

    cull_sign: +1 culls back faces, -1 front faces, 0 nothing; a triangle
    with flags bit 0 (double-sided) is never culled."""
    global KERNEL_LAUNCHES
    _check_tile_inputs(rows, rows_i, tri_list, offsets, tiles, cull_sign)
    dev = rows.device
    if dev.type == "cpu":
        return rasterize_tiles_ref(rows, rows_i, tri_list, offsets, tiles, cull_sign)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_tiles runs on cpu or cuda tensors, got {dev}")

    tiles_x, tiles_y = tiles
    shape = (tiles_y * TILE_H, tiles_x * TILE_W)
    out_z = torch.empty(shape, dtype=torch.float32, device=dev)
    out_tri = torch.empty(shape, dtype=torch.int32, device=dev)
    out_u = torch.empty_like(out_z)
    out_v = torch.empty_like(out_z)
    keys = torch.empty(shape, dtype=torch.int64, device=dev)  # the launch clears what it uses
    ins = [x.contiguous() for x in (rows, rows_i, tri_list, offsets)]
    _build.launch(_build.entry(_SOURCE, "raster_tiles_launch", _ARGTYPES), "raster_tiles",
                  dev.index, *[x.data_ptr() for x in ins], tri_list.shape[0], tiles_x, tiles_y,
                  int(cull_sign), keys.data_ptr(), out_z.data_ptr(), out_tri.data_ptr(),
                  out_u.data_ptr(), out_v.data_ptr())
    KERNEL_LAUNCHES += 1
    return out_z, out_tri, out_u, out_v


def rasterize_tiles_ref(rows, rows_i, tri_list, offsets, tiles: Tuple[int, int],
                        cull_sign: int = 1):
    """Plain PyTorch version of the kernel, on either device: the state is
    (n_tiles, 16, 128); step k gives every tile its k-th listed triangle
    (list order, so equal depths keep the first) and masks tiles whose list
    is shorter. Same operations in the same order as the kernel."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    tiles_x, tiles_y = tiles
    n_tiles = tiles_x * tiles_y
    dev = rows.device
    tile = torch.arange(n_tiles, device=dev)
    x0 = ((tile % tiles_x) * TILE_W).to(torch.float32)
    y0 = ((tile // tiles_x) * TILE_H).to(torch.float32)
    col = torch.arange(TILE_W, dtype=torch.float32, device=dev)
    row = torch.arange(TILE_H, dtype=torch.float32, device=dev)
    px = (x0[:, None, None] + col[None, None, :]) + 0.5     # (n, 1, 128)
    py = (y0[:, None, None] + row[None, :, None]) + 0.5     # (n, 16, 1)

    start = offsets[:-1].long()
    count = offsets[1:].long() - start
    zb = torch.zeros((n_tiles, TILE_H, TILE_W), dtype=torch.float32, device=dev)
    trib = torch.full((n_tiles, TILE_H, TILE_W), -1, dtype=torch.int32, device=dev)
    ub = torch.zeros_like(zb)
    vb = torch.zeros_like(zb)
    max_count = int(count.max()) if n_tiles else 0
    for k in range(max_count):
        active = (count > k)[:, None, None]
        # Tiles past their count re-read an in-range entry and are masked.
        pos = start + torch.clamp(torch.clamp(count - 1, max=k), min=0)
        slot = tri_list[torch.clamp(pos, max=tri_list.shape[0] - 1)].long()
        r = rows[slot]
        ri = rows_i[slot]

        def c(i):
            return r[:, i, None, None]

        ax, ay, bx, by, cx, cy = c(0), c(1), c(2), c(3), c(4), c(5)
        e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
        e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        is_back = area > 0.0
        inside_neg = (e0 <= 0.0) & (e1 <= 0.0) & (e2 <= 0.0)
        inside_pos = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
        inside = torch.where(is_back, inside_pos, inside_neg)
        if cull_sign:
            double_sided = ((ri[:, 1] & 1) != 0)[:, None, None]
            side = is_back if cull_sign > 0 else ~is_back
            inside = inside & ~(side & ~double_sided)
        area_ok = torch.abs(area) > 1e-12
        inv_area = torch.where(area_ok, 1.0 / area, torch.zeros_like(area))
        l0 = e0 * inv_area
        l1 = e1 * inv_area
        l2 = e2 * inv_area
        z = l0 * c(6) + l1 * c(7) + l2 * c(8)
        pw0 = l0 * c(9)
        pw1 = l1 * c(10)
        pw2 = l2 * c(11)
        denom = pw0 + pw1 + pw2
        inv_denom = torch.where(torch.abs(denom) > 1e-20, 1.0 / denom, torch.zeros_like(denom))
        u = (pw0 * c(12) + pw1 * c(14) + pw2 * c(16)) * inv_denom
        v = (pw0 * c(13) + pw1 * c(15) + pw2 * c(17)) * inv_denom
        take = active & inside & (z > zb) & (z <= 1.0) & (z >= 0.0) & area_ok
        zb = torch.where(take, z, zb)
        trib = torch.where(take, ri[:, 0, None, None], trib)
        ub = torch.where(take, u, ub)
        vb = torch.where(take, v, vb)

    def image(x):
        return (x.reshape(tiles_y, tiles_x, TILE_H, TILE_W).permute(0, 2, 1, 3)
                .reshape(tiles_y * TILE_H, tiles_x * TILE_W))

    return image(zb), image(trib), image(ub), image(vb)
