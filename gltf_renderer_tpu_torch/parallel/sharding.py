"""Sample x tile sharding of a frame over torch.distributed ranks.

Port of gltf_renderer_tpu/parallel/sharding.py. A mesh is an (n_sample,
n_tile) grid of cells. Cell (s, t) draws the pixel rows [t * tile_h,
(t + 1) * tile_h) of the image, tile_h = ceil(h / n_tile), with the seed
seed + s * SEED_STRIDE (mod 2^32): the tile axis splits the image, the
sample axis draws independent samples whose mean is the frame. Rows past
the image's bottom are extrapolated camera rays, cropped off. The RNG is
keyed by absolute pixel coordinates, so a cell's pixels are the unsharded
render's.

One process drives one device, so the mesh maps cells to ranks: rank r
owns the block of k = n_cells / world_size cells starting at r * k, in
(sample, tile) order, and renders them in turn. One process can thus
stand for a whole mesh (the tests draw meshes of 8 cells in one process).

The frame's collective is one all_gather of every rank's cells (and its
[ray_count, nan_count] stats); every rank then takes the sample mean in
sample order and returns the whole image. The mean is taken after the
gather, in a fixed order, so the image does not depend on the world size
or on a backend's reduction order: a mesh gives the same bits on one
rank and on n_cells ranks. The raster frame is deterministic, so its
sample axis is replicated; a rank draws the rows of its distinct tiles as
one region (one `rasterizer.render` call, whose `lit_gather` all-gathers
the lit regions so that every rank builds the transmission backdrop from
the whole image, as the JAX package does), then the final regions are
gathered.

No collective runs inside a data-dependent loop: the alpha retries run a
different number of hops on each rank, and each rank's cells finish
before its one gather. The hop counters and kernel launch counters are
per process; the stats a sharded path-tracer frame returns are the
frame's, summed over every rank in the gather.

Each gather is logged into `Mesh.log` as (name, gathered bytes, timing)
and `Mesh.collective_ms()` sums the timings. Under nccl the timing is a
pair of CUDA events on the stream, read after the frame's own wait. Under
gloo the gather waits on the host anyway (its CUDA tensors are staged
through host memory), and the timing is the host's ms, the device
synchronised on both sides.

Before each gather every rank's status is exchanged
(distributed.exchange, a small all_gather of pickled objects, not logged
or timed): a rank whose frame raised before the gather joins it with its
error (distributed.fail), and every rank raises RankFailed there instead
of waiting in a gather that rank never reaches. Reading the status waits
on the host for the rank's queued work, so under nccl the gather is
issued once the rank's cells are drawn.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gltf_renderer_tpu_torch.device import resolve, synchronize
from gltf_renderer_tpu_torch.ops import rng
from gltf_renderer_tpu_torch.parallel.distributed import exchange, uses_host_staging
from gltf_renderer_tpu_torch.render import pathtracer as pt
from gltf_renderer_tpu_torch.render import rasterizer

SAMPLE_AXIS = "sample"
TILE_AXIS = "tile"


@dataclasses.dataclass
class Mesh:
    """An (n_sample, n_tile) grid of cells over the group's ranks, seen
    from one rank."""

    n_sample: int
    n_tile: int
    rank: int
    world_size: int
    device: torch.device
    log: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=256), repr=False)

    @property
    def shape(self):
        return {SAMPLE_AXIS: self.n_sample, TILE_AXIS: self.n_tile}

    @property
    def n_cells(self) -> int:
        return self.n_sample * self.n_tile

    def collective_ms(self) -> float:
        """The logged collectives' summed ms. A CUDA event pair is read
        here, so call it after the frame's wait for the device."""
        return sum(t if isinstance(t, float) else t[0].elapsed_time(t[1])
                   for _, _, t in self.log)

    def cells(self, rank: Optional[int] = None):
        """[(sample, tile)] of the cells `rank` (this rank by default) owns."""
        rank = self.rank if rank is None else rank
        k = self.n_cells // self.world_size
        return [divmod(c, self.n_tile) for c in range(rank * k, (rank + 1) * k)]


def make_mesh(n_sample: int = 1, n_tile: Optional[int] = None, device="cuda") -> Mesh:
    """The (n_sample, n_tile) mesh over the process group (a world of 1
    without one). n_tile defaults to world_size // n_sample, one cell a
    rank; the cell count must be a multiple of the world size. device is
    this rank's (a card's index defaults to the current one)."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    if n_tile is None:
        n_tile = world // n_sample
    if n_sample < 1 or n_tile < 1 or (n_sample * n_tile) % world:
        raise ValueError(f"a {n_sample} x {n_tile} mesh does not split over {world} ranks")
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(n_sample, n_tile, rank, world, dev)


def _all_gather(mesh: Mesh, x, name: str):
    """(world_size, *x.shape): every rank's x in rank order. Without a
    process group (a world of 1) it is x itself. In a group, an exchange of
    every rank's status comes first (distributed.exchange): it raises
    RankFailed on every rank, before the gather, when a rank's frame
    raised."""
    if not dist.is_initialized():
        return x[None]
    if x.is_cuda and not uses_host_staging():
        exchange(None)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
        dist.all_gather(parts, x.contiguous())
        out = torch.stack(parts)
        end.record()
        mesh.log.append((name, out.numel() * out.element_size(), (start, end)))
        return out
    # gloo: a CUDA tensor is copied to the host and back explicitly
    # (uses_host_staging), so the gather waits on the host in any case.
    synchronize(mesh.device)
    exchange(None)
    t0 = time.perf_counter()
    parts = [torch.empty_like(x, device="cpu") for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.cpu().contiguous())
    out = torch.stack(parts).to(x.device)
    synchronize(mesh.device)
    mesh.log.append((name, out.numel() * out.element_size(), (time.perf_counter() - t0) * 1e3))
    return out


def render_sharded(scene: pt.PTScene, meta: pt.PTMeta, settings, params, clip_to_world,
                   resolution: Tuple[int, int], seed, mesh: Mesh, with_stats: bool = False):
    """One progressive sample a pixel, sharded over the mesh: the (h, w, 3)
    radiance on every rank, the mean of the mesh's n_sample samples (and
    the frame's [ray_count, nan_count] summed over every cell with
    with_stats)."""
    w, h = resolution
    tile_h = -(-h // mesh.n_tile)
    parts = []
    stats = torch.zeros(2, dtype=torch.float32, device=mesh.device)
    for s, t in mesh.cells():
        img, st = pt.trace(scene, meta, settings, params, clip_to_world, (w, tile_h),
                           (int(seed) + s * pt.SEED_STRIDE) & rng.M32,
                           pixel_offset=(0, t * tile_h), full_resolution=(w, h),
                           with_stats=True)
        parts.append(img.reshape(-1))
        stats = stats + st
    got = _all_gather(mesh, torch.cat(parts + [stats]), "path_tracer")
    cells = got[:, :-2].reshape(mesh.n_sample, mesh.n_tile, tile_h, w, 3)
    acc = cells[0]
    for s in range(1, mesh.n_sample):
        acc = acc + cells[s]
    if mesh.n_sample > 1:
        acc = acc / mesh.n_sample
    img = acc.reshape(mesh.n_tile * tile_h, w, 3)[:h]
    return (img, got[:, -2:].sum(0)) if with_stats else img


def _regions(mesh: Mesh):
    """[(first tile, tiles)] of each rank's raster region: the rows from
    its first to its last distinct tile."""
    out = []
    for r in range(mesh.world_size):
        tiles = [t for _, t in mesh.cells(r)]
        out.append((min(tiles), max(tiles) - min(tiles) + 1))
    return out


def render_raster_sharded(scene: pt.PTScene, meta: pt.PTMeta, render_settings, params,
                          clip_to_world, camera_pos, resolution: Tuple[int, int], frame,
                          mesh: Mesh, with_motion: bool = False, prev_world_to_clip=None,
                          prev_position=None):
    """One raster frame (raycast visibility) sharded over the mesh's tile
    axis: the (h, w, 3) image on every rank, and with with_motion the
    (h, w, 2) motion vectors too."""
    w, h = resolution
    tile_h = -(-h // mesh.n_tile)
    regions = _regions(mesh)
    rows = max(n for _, n in regions) * tile_h
    first, n_tiles = regions[mesh.rank]
    owner = {}
    for r, (a, n) in enumerate(regions):
        for t in range(a, a + n):
            owner.setdefault(t, r)

    def gather(region, name):
        pad = region.new_zeros((rows - region.shape[0],) + tuple(region.shape[1:]))
        got = _all_gather(mesh, torch.cat([region, pad]), name)
        full = [got[owner[t], (t - regions[owner[t]][0]) * tile_h:][:tile_h]
                for t in range(mesh.n_tile)]
        return torch.cat(full)[:h]

    out = rasterizer.render(scene, meta, render_settings, params, clip_to_world, camera_pos,
                            (w, n_tiles * tile_h), frame,
                            prev_world_to_clip=prev_world_to_clip, prev_position=prev_position,
                            with_motion=with_motion, pixel_offset=(0, first * tile_h),
                            full_resolution=(w, h),
                            lit_gather=lambda lit: gather(lit, "raster_lit"))
    if not with_motion:
        return gather(out, "raster")
    full = gather(torch.cat(out, -1), "raster")
    return full[..., :3], full[..., 3:]
