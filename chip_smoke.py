#!/usr/bin/env python3
"""Smoke run of the torch port's main paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
1. device and build: the card's name and power limit (nvidia-smi), then all
   five kernel sources in gltf_renderer_tpu_torch/csrc/ built in parallel,
   one nvcc each, with ptxas's report of every kernel's registers, stack
   frame, spills and shared memory;
2. BVH traversal kernel vs its plain PyTorch version on the bench scene's
   tables, for primary, bounce-like and lane-mixed ray sets under every
   cull/blend mode at 256x144 and at the main path's two launch sizes
   (t, u, v and word identical on every lane), and both timed at those
   sizes: the wrapper the path tracer calls (the kernel table's `ms`), and
   the kernel's C launcher on ready tensors in turns (`launcher_ms`); where
   build/parent/traverse.cu holds an older kernel source (copied there by
   hand; build/ is not committed), its launcher is built too and timed in
   the same turns;
3. path-tracer fidelity: the 256x144 probe (mean of seeds 1..32) against the
   committed CPU golden tests/goldens/bench_fidelity.npy by SSIM (bar
   0.995), no NaN/Inf;
4. the path tracer at full size: 1920x1080, trace_chunked(spp=4), one warm
   step and three timed steps, with the kernel launch counters reset first;
5. tile-rasterizer kernel vs its plain PyTorch version at 1920x1080 on the
   helmet's bench view and on a near-clipped view (and, in phase 7b, the
   courtyard's bench view): tri, z, u and v bit-identical; pair and crosser
   counts beside their caps; on both bench views the kernel timed through
   its wrapper and its C launcher, the plain version timed, and the bound
   from the inputs and outputs and the pixel centres inside the live pairs'
   boxes (the all-pixel count, and the key buffer's scratch bytes, beside
   it); where build/parent/raster.cu holds an older kernel source,
   its launcher is timed in turns with this one's (parent, new, new,
   parent) and its outputs held to this one's;
6. raster fidelity: the helmet-raster golden configuration (192x108, frame
   0) through raster_step + post_step in both visibilities, against the
   committed CPU golden tests/goldens/helmet_raster.png by SSIM (bar 0.99);
7. the raster frame at full size: bench scene, 1920x1080, tiled visibility +
   bloom + AgX -> u8, one warm and three timed frames, then the same with
   raycast visibility; the tile kernel launches once per tiled frame and no
   plain version runs;
7b. the courtyard (alpha MASK, alpha shadows, punctual lights): the
   courtyard bench scene built at 1920x1080; the traversal kernel vs its
   plain version on its tables for primary and lane-mixed rays at the main
   path's two launch sizes (t, u, v and word identical), timed through its
   wrapper; phase 5's tile-kernel check on its bench view; the courtyard
   golden configuration (128x72, two accumulated frames, tone mapped)
   against tests/goldens/courtyard_pt.png by SSIM (bar 0.99); the foliage
   scene (masked leaf, point light) at 48x48 with alpha shadows on and off,
   card against CPU at the CPU tests' bar; then the 1080p courtyard step,
   trace_chunked(spp=4), one warm and two timed steps, with every traversal
   launch accounted for (3 a chunk plus one a retry or alpha-shadow hop)
   and no plain version run;
8. brute-force closest-hit kernel (csrc/brute.cu, tensor cores) vs its
   plain version under ops/brute.compare_winners on five sets: the study
   tool's correctness data, 16,384 rays x 49,152 triangles with clipped
   ray intervals, 16,384 grazing rays (tools.bench_mxu.grazing_data)
   against a 49,152-triangle soup, and the tool's own scale-timing inputs
   at both widths it times, 262,144 rays x the helmet's 49,152 and the
   courtyard's 274,432 triangles (the plain version timed on each, one
   call; about 7 s and 40 s at the last two). Every ray must agree or be
   explained by rounding (0 unexplained), at least 99.9% of rays must
   agree on each set but the grazing one (built to disagree) and over all
   five, and the kernel's own sums (brute_sums) on 256 rays of each set
   must lie within compare_winners' delta of the exact sums; the largest
   such deviation is the kernel table's max_abs_err (and max_sum_dev). At
   both widths the kernel is timed in turns with the old CUDA-core kernel
   where build/parent/brute.cu holds its source (copied there by hand;
   build/ is not committed). Then the main of the study tool `python -m
   gltf_renderer_tpu_torch.tools.bench_mxu` with the launch counters
   reset: correctness against numpy, the torch.mm depth curve (its depth-16
   rate is written beside the kernel's product rate), and the kernel timed
   at both widths;
9. per-lane fetch kernels (csrc/perlane.cu) vs their plain versions,
   bit-identical at the tool's three table shapes (plain versions timed),
   then `python -m gltf_renderer_tpu_torch.tools.bench_perlane`'s main with
   the launch counters reset: its pointer chases measure the card's L1 and
   L2 hit latencies, and each kernel's latency floor (32 dependent loads,
   as many L1 hits as its chains allow and L2 hits for the rest) is logged
   beside its byte bound (the kernels line's `latency_floor_ms`);
10. the port's bench entry point, `python -m gltf_renderer_tpu_torch.bench`,
   as a subprocess at 1920x1080 with BENCH_STEPS=3: one JSON line on
   stdout with the headline metric > 0, both gates true and raster FPS > 0;
   then again with BENCH_SCENE=courtyard BENCH_STEPS=2: the courtyard
   metric > 0 and no NaN/Inf pixel.

Before phase 2 the warm-up kernel (csrc/warm.cu) runs once, as the bench
runs it first, is held against its plain version and is timed in turns
with torch.add.

The second-to-last lines are the kernel table as JSON and the card's name
and power limit; the last line is {"ok": true, "device": {...}}.
"""

import itertools
import json
import os
import statistics
import sys
import time

import numpy as np

from gltf_renderer_tpu_torch.device import cuda_ms
from gltf_renderer_tpu_torch.tools import bench_traverse

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "bench_fidelity.npy")
RASTER_GOLDEN = os.path.join(ROOT, "tests", "goldens", "helmet_raster.png")
COURTYARD_GOLDEN = os.path.join(ROOT, "tests", "goldens", "courtyard_pt.png")
FULL_RES = (1920, 1080)
SPP = 4
TIMED_STEPS = 3
COURTYARD_TIMED_STEPS = 2
FOLIAGE_RES = (48, 48)
SSIM_BAR = 0.995
RASTER_SSIM_BAR = 0.99  # tests/test_ssim_baseline.py's golden bar
REPLACES = "gltf_renderer_tpu/ops/pallas_trace.py:123"
RASTER_REPLACES = "gltf_renderer_tpu/ops/pallas_raster.py:248"
BRUTE_REPLACES = "tools/bench_mxu.py:108"
ONEHOT_REPLACES = "tools/bench_perlane.py:47"
SHUFFLE_REPLACES = "tools/bench_perlane.py:92"
WARM_REPLACES = "bench.py:230"
PARENT_K1 = os.path.join(ROOT, "build", "parent", "traverse.cu")  # optional, for phase 2's turns
PARENT_K2 = os.path.join(ROOT, "build", "parent", "raster.cu")  # optional, for phase 5's turns
PARENT_K3 = os.path.join(ROOT, "build", "parent", "brute.cu")  # optional, for phase 8's turns
BRUTE_AGREE_BAR = 0.999  # share of rays on which K3 and its plain version name the same winner
SOURCES = ("traverse.cu", "raster.cu", "warm.cu", "brute.cu", "perlane.cu")
PERLANE_ROW = "courtyard-node"  # the table shape phase 9 reports in the kernel table
BENCH_TIMEOUT_S = 600
NEAR_VIEW_EYE = ([0.52, 0.0, 0.0], [0.52, 1.0, 0.0])  # camera plane cuts the sphere

# Peak rates of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores, dense bf16 operations/s in them.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12
# f32 operations the kernels execute, counted from their sources (compares
# included): a BVH node visit tests 4 child boxes at 25 each; a leaf visit
# tests 16 triangles at 53 each; a live (triangle, tile) pair costs 29 per
# pixel centre inside its box (edge functions, inside test, barycentric
# weights, depth and its range test, as the plain version counts them; the
# winner's u, v are not counted).
OPS_NODE_VISIT = 4 * 25
OPS_LEAF_VISIT = 16 * 53
OPS_PAIR_PIXEL = 29
# The brute-force kernel's four 16-term products are 128 operations a (ray,
# triangle) pair, timed at the bf16 tensor-core rate apart from the f32
# epilogue, since the two units overlap on Hopper; its epilogue is 19
# f32 operations a pair (m3, m4, m5: 6; 12 compares; the or); the key
# (division, mask, or, compare) is made for hits only and not counted (the
# CUDA-core kernel it replaced built it for every pair: 22). A per-lane
# step sums 8 columns into s and s into acc (one-hot: 9 adds a lane); the
# shuffle step adds one value per (column, lane).
OPS_BRUTE_PRODUCTS = 4 * 2 * 16
OPS_BRUTE_EPILOGUE = 19
OPS_ONEHOT_LANE_STEP = 9


def log(msg):
    print(msg, flush=True)


def bound(n_bytes, n_ops, n_bf16_ops=0):
    """(bound_ms, bound_by): the largest of bytes over the HBM rate, f32
    operations over the f32 rate and bf16 tensor operations over the bf16
    tensor-core rate (the tensor cores run beside the f32 units)."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = max(n_ops / PEAK_F32_S, n_bf16_ops / PEAK_BF16_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(int(t.numel()) * t.element_size() for t in tensors if t is not None)


def compare(scene, meta, rays, cull, blend):
    """Kernel vs plain on one ray set, every lane (closest and any-hit).
    Returns (word agreement, max abs error of t, max relative error of t,
    u and v, identical): identical when t, u, v and word are the same
    32-bit words on every lane."""
    import torch

    from gltf_renderer_tpu_torch.ops import traverse as tr

    _, o, d, tmn, tmx, mode = rays
    any_hit = "lane" if mode is not None else False
    args = (scene.wide_nodes, scene.wide_maps.meta, scene.leaf_records, scene.leaf_words,
            o, d, tmn, tmx, meta.wide_root, any_hit, cull, blend, mode)
    k = tr.traverse_wide(*args, stack_bound=meta.stack_bound)
    p = tr.traverse_wide_ref(*args, stack_bound=meta.stack_bound)
    kt, kw, ku, kv = k
    pt_, pw, pu, pv = p
    max_abs = float(torch.abs(kt - pt_).max())
    max_rel = 0.0
    for a, b in ((kt, pt_), (ku, pu), (kv, pv)):
        diff = torch.abs(a - b)
        rel = torch.where(diff == 0, torch.zeros_like(diff),
                          diff / torch.clamp(torch.abs(b), min=1e-30))
        max_rel = max(max_rel, float(rel.max()))
    same = all(identical(a, b) for a, b in zip(k, p))
    return float((kw == pw).float().mean()), max_abs, max_rel, same


def phase_kernel_vs_plain(scene, meta, params, c2w, device):
    sets = bench_traverse.ray_sets(scene, meta, params, c2w, (256, 144), device)
    worst_abs = 0.0
    for rays in sets:
        for cull in (-1, 0, 1):
            for blend in (0, 1, 2):
                frac, max_abs, max_rel, same = compare(scene, meta, rays, cull, blend)
                log(f"[kernel] {rays[0]:10s} cull={cull:+d} blend={blend} "
                    f"rays={rays[1].shape[0]} word_agree={frac:.6f} max_rel_tuv={max_rel:.3e} "
                    f"identical={same}")
                if not same:
                    raise AssertionError(f"kernel disagrees with plain version on {rays[0]} "
                                         f"cull={cull} blend={blend}")
                worst_abs = max(worst_abs, max_abs)

    # Times at the main path's launch sizes: 1080p spp=4 chunks are 262144
    # primary rays and 2 x 262144 merged bounce + shadow rays.
    big = bench_traverse.ray_sets(scene, meta, params, c2w, bench_traverse.RAYS_RES, device)
    times = {}
    for rays in (big[0], big[2]):
        row = k1_main_size(scene, meta, rays, "[kernel]")
        worst_abs = max(worst_abs, row["max_abs"])
        row["launcher_ms"] = launcher_turns(scene, meta, rays)
        times[rays[0]] = row
    return worst_abs, times


def k1_main_size(scene, meta, rays, tag):
    """K1 against its plain version on one main-path-size ray set (t, u, v
    and word identical, or raise), then timed through its wrapper, the plain
    version timed, and the bound from the visits this data needs. Returns
    {n, ms, plain_ms, bound_ms, bound_by, max_abs}."""
    from gltf_renderer_tpu_torch.ops import traverse as tr

    frac, max_abs, max_rel, same = compare(scene, meta, rays, 0, 0)
    _, o, d, tmn, tmx, mode = rays
    log(f"{tag} {rays[0]:10s} rays={o.shape[0]} word_agree={frac:.6f} "
        f"max_rel_tuv={max_rel:.3e} identical={same}")
    if not same:
        raise AssertionError(f"kernel disagrees with plain version on {rays[0]} (main-path size)")
    args = bench_traverse.wrapper_args(scene, meta, rays)
    ms_w = cuda_ms(lambda: tr.traverse_wide(*args, stack_bound=meta.stack_bound), 20)
    ms_p = cuda_ms(lambda: tr.traverse_wide_ref(*args, stack_bound=meta.stack_bound), 2)
    visits = {}
    tr.traverse_wide_ref(*args, stack_bound=meta.stack_bound, visits=visits)
    n_bytes = nbytes(*args[:8], mode) + 16 * o.shape[0]
    n_ops = visits["node"] * OPS_NODE_VISIT + visits["leaf"] * OPS_LEAF_VISIT
    b_ms, b_by = bound(n_bytes, n_ops)
    log(f"{tag} time {rays[0]} rays={o.shape[0]} kernel={ms_w:.4f} ms (through traverse_wide) "
        f"plain={ms_p:.3f} ms node_visits={visits['node']} leaf_visits={visits['leaf']} "
        f"bytes={n_bytes} ops={n_ops} bound={b_ms:.4f} ms ({b_by})")
    return dict(n=o.shape[0], ms=ms_w, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
                max_abs=max_abs)


def launcher_turns(scene, meta, rays):
    """K1's own time on `rays`: its C launcher on ready tensors, 20 launches
    per timing, 4 timings. Where PARENT_K1 holds an older kernel's source
    (put there by hand), that kernel's launcher, its argument list read from
    the library, is timed in turns with this one (parent, new, new,
    parent, ...) and its hits compared. Returns this kernel's median ms."""
    from gltf_renderer_tpu_torch.ops import _build

    fns, outs = {}, {}
    if os.path.exists(PARENT_K1):
        fns["parent"], outs["parent"] = bench_traverse.launcher(
            _build.load(PARENT_K1), scene, meta, rays)
    fns["new"], outs["new"] = bench_traverse.launcher(_build.load("traverse.cu"), scene, meta,
                                                      rays)
    times = bench_traverse.time_in_turns(fns, rounds=4)
    log(f"[kernel] turns {rays[0]} rays={rays[1].shape[0]} "
        + " ".join(f"{k}={[round(x, 5) for x in v]} ms" for k, v in times.items())
        + " (CUDA events, 20 launches each, C launcher)")
    if "parent" in outs:
        log(f"[kernel] turns {rays[0]}: parent's t identical="
            f"{identical(outs['parent'][0], outs['new'][0])}, words differing="
            f"{int((outs['parent'][1] != outs['new'][1]).sum())}")
    else:
        log(f"[kernel] turns: no parent kernel source at {PARENT_K1}, parent not timed")
    return statistics.median(times["new"])


def phase_fidelity(scene, meta, settings, params):
    from gltf_renderer_tpu_torch.bench import render_fidelity_probe
    from gltf_renderer_tpu_torch.bench_scene import FIDELITY_RES, FIDELITY_SPP, bench_camera
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    w, h = FIDELITY_RES
    probe, nan = render_fidelity_probe(scene, meta, settings, params, bench_camera(w, h))
    golden = np.load(GOLDEN).astype(np.float32)
    if golden.shape != probe.shape:
        raise AssertionError(f"probe {probe.shape} vs golden {golden.shape}")
    data_range = float(max(golden.max(), probe.max(), 1e-6))
    score = ssim(probe, golden, data_range=data_range)
    log(f"[fidelity] {w}x{h} mean of seeds 1..{FIDELITY_SPP}: ssim={score:.5f} "
        f"(bar {SSIM_BAR}) nan_inf={nan:.0f} mean={probe.mean():.5f} golden_mean={golden.mean():.5f}")
    if not np.isfinite(probe).all() or nan != 0.0 or score < SSIM_BAR:
        raise AssertionError("fidelity phase failed")
    return score


def phase_main_path(scene, meta, settings, params, c2w, card):
    import torch

    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    w, h = FULL_RES

    def step(seed):
        img, stats = pt.trace_chunked(scene, meta, settings, params, c2w, (w, h), seed,
                                      with_stats=True, spp=SPP)
        return img, stats

    tr.KERNEL_LAUNCHES = 0
    ref_calls = tr.REFERENCE_CALLS
    t0 = time.perf_counter()
    img, _ = step(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rays = 0.0
    nan = 0.0
    step_s = []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        img, stats = step(i + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        rays += float(stats[0])
        nan += float(stats[1])
    launches = tr.KERNEL_LAUNCHES
    # Per step and chunk: one primary launch and one merged bounce + shadow
    # launch per bounce.
    chunks = -(-pt._tile_order(w, h, img.device)[0].shape[0] // (pt.RAY_CHUNK // SPP))
    per_step = chunks * (1 + settings.max_bounces)
    elapsed = sum(step_s)
    mrays = rays / elapsed / 1e6
    log(f"[main] {w}x{h} spp={SPP} warm={warm_s:.3f}s steps={[round(s, 4) for s in step_s]} "
        f"rays={rays:.0f} Mrays/s={mrays:.4f} nan_inf={nan:.0f} launches={launches} "
        f"({per_step} a step expected) card={card}")
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("main path image has the wrong shape or non-finite values")
    if launches != per_step * (TIMED_STEPS + 1) or tr.REFERENCE_CALLS != ref_calls:
        raise AssertionError("main path did not run through the traversal kernel only")
    return launches, mrays, step_s


def near_view(res):
    from gltf_renderer_tpu_torch import camera

    eye, target = NEAR_VIEW_EYE
    w2v = camera.look_at(eye, target)
    return camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=res[0] / res[1], z_near=0.01)


def raster_work(ins):
    """What the tile kernel's function needs on one view (cull +1): live
    (triangle, tile) pairs (not culled, |area| > 1e-12), the pixel centres
    inside each live pair's screen box and tile, and the tiles whose list
    spans more than one work item."""
    import torch

    from gltf_renderer_tpu_torch.ops import raster

    n = int(ins.offsets[-1])
    pos = torch.arange(n, device=ins.offsets.device)
    slot = ins.tri_list[:n].long()
    tile = torch.searchsorted(ins.offsets.long(), pos, right=True) - 1
    r = ins.rows[slot]
    ax, ay, bx, by, cx, cy = (r[:, i] for i in range(6))
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    culled = (area > 0.0) & ((ins.rows_i[slot, 1] & 1) == 0)
    live = (torch.abs(area) > 1e-12) & ~culled

    def centres(lo, hi, origin, size):
        # pixel centres origin + i + 0.5, 0 <= i < size, within [lo, hi]
        first = torch.clamp(torch.ceil(lo - origin - 0.5), 0, size)
        last = torch.clamp(torch.floor(hi - origin - 0.5), -1, size - 1)
        return torch.clamp(last - first + 1, min=0)

    tiles_x = ins.tiles[0]
    x0 = ((tile % tiles_x) * raster.TILE_W).float()
    y0 = ((tile // tiles_x) * raster.TILE_H).float()
    nx = centres(torch.minimum(torch.minimum(ax, bx), cx),
                 torch.maximum(torch.maximum(ax, bx), cx), x0, raster.TILE_W)
    ny = centres(torch.minimum(torch.minimum(ay, by), cy),
                 torch.maximum(torch.maximum(ay, by), cy), y0, raster.TILE_H)
    counts = torch.diff(ins.offsets)
    return dict(valid=n, live=int(live.sum()), in_box_px=int((nx * ny)[live].sum()),
                merged_tiles=int((counts > raster.CHUNK).sum()), longest=int(counts.max()))


def raster_bound(ins, outs, work):
    """(bound ms, bound by, all-pixel bound ms, bytes, ops, key bytes).
    Bytes: what the function must move, the inputs once (every setup row,
    the valid list entries, the offsets) and the four outputs. Operations:
    OPS_PAIR_PIXEL on each pixel centre inside a live pair's box; the
    all-pixel count (every one of a live pair's 2,048 tile pixels, the count
    until this kernel) beside it. Key bytes: the design's own scratch
    traffic, not in the bound: the clear, one atomic write and one read of
    each merged tile's 8-byte keys."""
    from gltf_renderer_tpu_torch.ops import raster

    tile_px = raster.TILE_H * raster.TILE_W
    n_bytes = nbytes(ins.rows, ins.rows_i, ins.offsets) + 4 * work["valid"] + nbytes(*outs)
    n_ops = work["in_box_px"] * OPS_PAIR_PIXEL
    b_ms, b_by = bound(n_bytes, n_ops)
    all_ms, _ = bound(n_bytes, work["live"] * tile_px * OPS_PAIR_PIXEL)
    key_bytes = 3 * 8 * tile_px * work["merged_tiles"]
    return b_ms, b_by, all_ms, n_bytes, n_ops, key_bytes


def raster_launcher(lib, args):
    """A no-argument launch of `lib`'s raster_tiles_launch (its argument
    list read from raster_tiles_abi; a library without it is version 1) on
    the wrapper's arguments `args` (cull +1) into fresh outputs, and the
    outputs."""
    import ctypes

    import torch

    from gltf_renderer_tpu_torch.ops import raster

    rows, rows_i, tri_list, offsets, (tiles_x, tiles_y) = args
    abi = lib.raster_tiles_abi() if hasattr(lib, "raster_tiles_abi") else 1
    shape = (tiles_y * raster.TILE_H, tiles_x * raster.TILE_W)
    outs = [torch.empty(shape, dtype=dt, device=rows.device)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    ptrs = [x.data_ptr() for x in (rows, rows_i, tri_list, offsets)]
    if abi == 1:
        ints = [tiles_x, tiles_y, 1]
        scratch = []
    elif abi == 2:
        ints = [tri_list.shape[0], tiles_x, tiles_y, 1]
        scratch = [torch.empty(shape, dtype=torch.int64, device=rows.device)]
    else:
        raise RuntimeError(f"raster_tiles_launch version {abi} is not known here")
    fn = lib.raster_tiles_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p] * (len(scratch) + 5))
    fn.restype = ctypes.c_int
    call = ptrs + ints + [x.data_ptr() for x in scratch + outs]

    def run():
        if fn(*call, torch._C._cuda_getCurrentRawStream(rows.get_device())) != 0:
            raise RuntimeError("raster_tiles_launch failed")

    return run, outs


def raster_turns(args):
    """The tile kernel's C launcher on ready tensors, and where PARENT_K2
    holds an older kernel's source that kernel's launcher, timed in turns
    (parent, new, new, parent, ...; CUDA events, 20 launches each, 4
    rounds); the parent's outputs held to this kernel's bit for bit.
    Returns {name: [ms, ...]}."""
    import torch

    from gltf_renderer_tpu_torch.ops import _build

    fns, outs = {}, {}
    if os.path.exists(PARENT_K2):
        fns["parent"], outs["parent"] = raster_launcher(_build.load(PARENT_K2), args)
    fns["new"], outs["new"] = raster_launcher(_build.load("raster.cu"), args)
    times = bench_traverse.time_in_turns(fns, rounds=4)
    torch.cuda.synchronize()
    if "parent" in outs:
        same = all(identical(a, b) for a, b in zip(outs["parent"], outs["new"]))
        if not same:
            raise AssertionError("the parent tile kernel and this one disagree")
    else:
        log(f"[raster] turns: no parent kernel source at {PARENT_K2}, parent not timed")
    return times


def raster_view(name, world, c2w, timed):
    """Tile kernel vs plain version (cull +1) at 1080p on one view: z, tri,
    u and v identical or raise. When `timed`: the kernel through its wrapper
    (20 calls), its launcher in turns with the parent's, the plain version
    (its one checking call), and the bound. Returns a dict of the numbers."""
    import torch

    from gltf_renderer_tpu_torch import camera
    from gltf_renderer_tpu_torch.ops import raster

    w, h = FULL_RES
    ins = raster.prepare_tiles(world.position, world.tri_vertex, camera.world_to_clip(c2w),
                               w, h, double_sided=world.tri_double_sided)
    args = (ins.rows, ins.rows_i, ins.tri_list, ins.offsets, ins.tiles)
    got = raster.rasterize_tiles(*args, cull_sign=1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want = raster.rasterize_tiles_ref(*args, cull_sign=1)
    end.record()
    torch.cuda.synchronize()
    same = {n: identical(g, p) for n, g, p in zip(("z", "tri", "u", "v"), got, want)}
    err = max(float(torch.abs(g.float() - p.float()).max()) for g, p in zip(got, want))
    covered = int((want[1] >= 0).sum())
    pairs, crossers = int(ins.n_pairs), int(ins.n_cross)
    log(f"[raster] {name} {w}x{h} tiles={ins.tiles} rows={ins.rows.shape[0]} "
        f"pairs={pairs}/{ins.pair_cap} crossers={crossers}/{ins.clip_cap} "
        f"covered_px={covered} identical={same} max_abs_err={err}")
    if not all(same.values()) or covered == 0:
        raise AssertionError(f"tile kernel disagrees with its plain version on {name}")
    if pairs > ins.pair_cap or crossers > ins.clip_cap:
        log(f"[raster] {name}: pairs or crossers past their cap were dropped")
    out = dict(err=err, crossers=crossers)
    if not timed:
        return out
    ms_k = cuda_ms(lambda: raster.rasterize_tiles(*args, cull_sign=1), 20)
    turns = raster_turns(args)
    work = raster_work(ins)
    b_ms, b_by, all_ms, n_bytes, n_ops, key_bytes = raster_bound(ins, got, work)
    log(f"[raster] time {name} kernel={ms_k:.4f} ms (through rasterize_tiles) "
        f"plain={start.elapsed_time(end):.3f} ms (one call) bound={b_ms:.4f} ms ({b_by}; "
        f"bytes={n_bytes} ops={n_ops}) all-pixel bound={all_ms:.4f} ms; "
        f"key buffer overhead {key_bytes} bytes ({key_bytes / PEAK_BYTES_S * 1e3:.4f} ms at "
        f"the HBM rate, not in the bound); "
        f"live_pairs={work['live']}/{work['valid']} in_box_px={work['in_box_px']} "
        f"longest_list={work['longest']} merged_tiles={work['merged_tiles']}")
    log(f"[raster] turns {name}: " + " ".join(f"{k}={[round(x, 5) for x in v]} ms"
                                              for k, v in turns.items())
        + " (CUDA events, 20 launches each, C launchers on ready tensors)")
    log(f"[raster] device time by operation, {name} (torch.profiler, 10 calls): "
        + ", ".join(f"{k} {v:.2f} us" for k, v in device_us_by_op(
            lambda: raster.rasterize_tiles(*args, cull_sign=1)).items()))
    return dict(out, ms=ms_k, plain_ms=start.elapsed_time(end), bound_ms=b_ms, bound_by=b_by,
                bound_all_px_ms=all_ms, launcher_ms=statistics.median(turns["new"]),
                parent_ms=turns.get("parent"))


def device_us_by_op(fn, calls=10):
    """{operation: device microseconds a call of fn} from torch.profiler's
    CUDA activity over `calls` calls (kernel names cut at their argument
    list)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if us and ev.count:
            out[ev.key.replace("(anonymous namespace)::", "").split("(")[0]] = us / calls
    return out


def phase_raster_kernel(scene):
    """Tile kernel vs plain version at 1080p on the helmet's bench view
    (timed) and a near-clipped view. Returns the bench view's numbers."""
    from gltf_renderer_tpu_torch.bench_scene import bench_camera

    row = raster_view("bench", scene.world, bench_camera(*FULL_RES), timed=True)
    near = raster_view("near_clipped", scene.world, near_view(FULL_RES), timed=False)
    if near["crossers"] == 0:
        raise AssertionError("the near-clipped view clips no triangle")
    return dict(row, err=max(row["err"], near["err"]))


def phase_raster_fidelity(device):
    import torch

    from PIL import Image

    from gltf_renderer_tpu_torch.bench_scene import build_raster_fidelity_scene
    from gltf_renderer_tpu_torch.render import renderer
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    from gltf_renderer_tpu_torch import camera
    from gltf_renderer_tpu_torch.ops import raster

    scene, meta, rs, params, c2w, cam_pos, res = build_raster_fidelity_scene(device=device)
    ins = raster.prepare_tiles(scene.world.position, scene.world.tri_vertex,
                               camera.world_to_clip(c2w), *res,
                               double_sided=scene.world.tri_double_sided)
    log(f"[raster-fidelity] {res[0]}x{res[1]} pairs={int(ins.n_pairs)}/{ins.pair_cap} "
        f"crossers={int(ins.n_cross)}/{ins.clip_cap}")
    golden = np.asarray(Image.open(RASTER_GOLDEN))
    scores = {}
    for vis in ("raycast", "tiled"):
        hdr = renderer.raster_step(scene, meta, rs, params, c2w, cam_pos, res, 0, visibility=vis)
        img = renderer.post_step(hdr, rs.tonemap, rs.bloom, 0).cpu().numpy()
        if img.shape != golden.shape or not bool(torch.isfinite(hdr).all()):
            raise AssertionError(f"raster fidelity {vis}: shape {img.shape} or non-finite HDR")
        scores[vis] = ssim(img, golden)
        diff = np.abs(img.astype(np.int16) - golden.astype(np.int16))
        log(f"[raster-fidelity] {vis} {res[0]}x{res[1]} ssim={scores[vis]:.5f} "
            f"(bar {RASTER_SSIM_BAR}) u8 within 1: {(diff <= 1).all(-1).mean():.5f} "
            f"max diff {int(diff.max())}")
    if scores["raycast"] < RASTER_SSIM_BAR or scores["tiled"] < RASTER_SSIM_BAR:
        raise AssertionError(f"raster fidelity below the bar: {scores}")
    return scores


def phase_raster_frame(scene, meta, params, c2w, card):
    """The raster frame at 1080p in both visibilities. Returns
    {visibility: (K1 launches, K2 launches, draw seconds, post seconds)}."""
    import torch

    from gltf_renderer_tpu_torch.ops import raster
    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import renderer
    from gltf_renderer_tpu_torch.render import settings as S

    w, h = FULL_RES
    rs = S.RenderSettings(backend="rasterizer", width=w, height=h)
    cam_pos = np.asarray([1.1, -1.1, 0.6], np.float32)  # the bench camera's eye
    out = {}
    for vis in ("tiled", "raycast"):
        tr.KERNEL_LAUNCHES = 0
        raster.KERNEL_LAUNCHES = 0
        refs = (tr.REFERENCE_CALLS, raster.REFERENCE_CALLS)
        draw_s, post_s = [], []
        for i in range(TIMED_STEPS + 1):
            t0 = time.perf_counter()
            hdr = renderer.raster_step(scene, meta, rs, params, c2w, cam_pos, (w, h), i,
                                       visibility=vis)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            img = renderer.post_step(hdr, rs.tonemap, rs.bloom, i)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i:
                draw_s.append(t1 - t0)
                post_s.append(t2 - t1)
        frames = TIMED_STEPS + 1
        k1, k2 = tr.KERNEL_LAUNCHES, raster.KERNEL_LAUNCHES
        log(f"[raster-frame] {vis} {w}x{h} draw={[round(x * 1e3, 3) for x in draw_s]} ms "
            f"post={[round(x * 1e3, 3) for x in post_s]} ms traverse_launches={k1} "
            f"raster_launches={k2} frames={frames} card={card}")
        if tuple(img.shape) != (h, w, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"raster frame {vis}: wrong output {tuple(img.shape)} {img.dtype}")
        if not bool(torch.isfinite(hdr).all()):
            raise AssertionError(f"raster frame {vis}: non-finite HDR values")
        if (tr.REFERENCE_CALLS, raster.REFERENCE_CALLS) != refs:
            raise AssertionError(f"raster frame {vis} ran a plain version")
        if vis == "tiled" and (k2 != frames or k1 != 0):
            raise AssertionError(f"tiled frames launched the tile kernel {k2} times in {frames}")
        if vis == "raycast" and (k1 <= 0 or k2 != 0):
            raise AssertionError("raycast frames did not run through the traversal kernel")
        out[vis] = (k1, k2, draw_s, post_s)
    from gltf_renderer_tpu_torch import camera

    world = scene.world
    w2c = camera.world_to_clip(c2w)
    prep_ms = cuda_ms(lambda: raster.prepare_tiles(world.position, world.tri_vertex, w2c, w, h,
                                                   double_sided=world.tri_double_sided), 3)
    ins = raster.prepare_tiles(world.position, world.tri_vertex, w2c, w, h,
                               double_sided=world.tri_double_sided)
    log(f"[raster-frame] tiled visibility set-up + near clip + binning: {prep_ms:.3f} ms "
        f"(CUDA events, 3 calls); pairs={int(ins.n_pairs)}/{ins.pair_cap} "
        f"crossers={int(ins.n_cross)}/{ins.clip_cap}")
    return out


def images_match(got, want):
    """The CPU tests' bar for two renders (tests/test_torch_pathtracer.py):
    (share of pixels within atol 1e-4 + rtol 1e-3, relative difference of
    the means, passes: share >= 0.98 and means within 1%)."""
    close = np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)
    frac = float(close.all(-1).mean())
    rel = abs(float(got.mean()) - float(want.mean())) / max(abs(float(want.mean())), 1e-30)
    return frac, rel, frac >= 0.98 and rel <= 0.01


def phase_courtyard(device, card):
    """The courtyard bench scene on the card (phase 7b). Returns the
    traversal kernel's courtyard numbers and the main-path run's counts."""
    import torch

    from PIL import Image

    from gltf_renderer_tpu_torch.bench_scene import build_bench_scene, render_courtyard_golden
    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    t0 = time.perf_counter()
    scene, meta, settings, params, c2w, n_tris = build_bench_scene(
        *FULL_RES, device=device, scene_kind="courtyard")
    log(f"[courtyard] {n_tris} triangles, stack bound {meta.stack_bound}, "
        f"{scene.wide_nodes.shape[0]} wide nodes, {scene.leaf_records.shape[0]} leaves, "
        f"has_masked={meta.has_masked}, built in {time.perf_counter() - t0:.2f}s")
    if not meta.has_masked or n_tris != 273856:
        raise AssertionError("the courtyard scene is not the bench's")

    # K1 against its plain version on the courtyard's tables, at the main
    # path's two launch sizes; timed through its wrapper.
    sets = bench_traverse.ray_sets(scene, meta, params, c2w, bench_traverse.RAYS_RES, device)
    k1 = {rays[0]: k1_main_size(scene, meta, rays, "[courtyard] kernel")
          for rays in (sets[0], sets[2])}
    # Phase 5's tile-kernel check and timing on the courtyard's bench view.
    k2 = raster_view("courtyard", scene.world, c2w, timed=True)

    # The golden configuration, drawn as the renderer draws it.
    img, stats = render_courtyard_golden(device)
    golden = np.asarray(Image.open(COURTYARD_GOLDEN))
    img = img.cpu().numpy()
    score = ssim(img, golden) if img.shape == golden.shape else 0.0
    log(f"[courtyard] golden {img.shape[1]}x{img.shape[0]} ssim={score:.5f} "
        f"(bar {RASTER_SSIM_BAR}) nan_inf={float(stats[1]):.0f}")
    if score < RASTER_SSIM_BAR or float(stats[1]) != 0.0:
        raise AssertionError("the courtyard golden fails its bar")

    phase_foliage(device)

    # The 1080p step: every traversal launch is a chunk's primary or merged
    # bounce launch, or one hop of a retry or alpha-shadow loop.
    w, h = FULL_RES
    tr.KERNEL_LAUNCHES = 0
    pt.ALPHA_RETRY_HOPS = pt.ALPHA_SHADOW_HOPS = 0
    ref_calls = tr.REFERENCE_CALLS
    rays = nan = 0.0
    step_s, hops = [], []
    img = None
    for i in range(COURTYARD_TIMED_STEPS + 1):
        hops0 = (pt.ALPHA_RETRY_HOPS, pt.ALPHA_SHADOW_HOPS)
        t0 = time.perf_counter()
        img, st = pt.trace_chunked(scene, meta, settings, params, c2w, (w, h), i,
                                   with_stats=True, spp=SPP)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        hops.append((pt.ALPHA_RETRY_HOPS - hops0[0], pt.ALPHA_SHADOW_HOPS - hops0[1]))
        if i:
            step_s.append(dt)
            rays += float(st[0])
        nan += float(st[1])
    launches = tr.KERNEL_LAUNCHES
    chunks = -(-pt._tile_order(w, h, img.device)[0].shape[0] // (pt.RAY_CHUNK // SPP))
    steps = COURTYARD_TIMED_STEPS + 1
    expected = steps * chunks * (1 + settings.max_bounces) + sum(a + b for a, b in hops)
    mrays = rays / sum(step_s) / 1e6
    log(f"[courtyard] main {w}x{h} spp={SPP} steps={[round(x, 4) for x in step_s]} "
        f"(after one warm) rays={rays:.0f} Mrays/s={mrays:.4f} nan_inf={nan:.0f} "
        f"traverse_launches={launches} in {steps} steps ({launches / steps:.1f} a step; "
        f"{chunks * (1 + settings.max_bounces)} a step without hops) "
        f"retry/shadow hops per step={hops} card={card}")
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()) or nan != 0.0:
        raise AssertionError("the courtyard step has the wrong shape or non-finite values")
    if launches != expected or tr.REFERENCE_CALLS != ref_calls:
        raise AssertionError(f"the courtyard step did not run through the traversal kernel "
                             f"only: {launches} launches, {expected} expected")
    if sum(a for a, _ in hops) == 0:
        raise AssertionError("the courtyard step ran no masked retry")
    return dict(k1=k1, k2=k2, launches=launches, steps=steps, hops=hops, mrays=mrays,
                step_s=step_s)


def phase_foliage(device):
    """Foliage (alpha-MASKed leaf, one point light) at 48x48 on the card
    against the same render on the CPU, alpha shadows on and off."""
    from gltf_renderer_tpu_torch import camera
    from gltf_renderer_tpu_torch.bench_scene import world_from_scene
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import settings as S
    from gltf_renderer_tpu_torch.scene.procedural import foliage_scene

    src = foliage_scene()
    world, lights = world_from_scene(src)
    built = {dev: pt.make_pt_scene(world, src.materials, src.textures, lights, device=dev)
             for dev in ("cpu", device)}
    c2w = camera.clip_to_world(camera.look_at([0.0, -4.0, 1.0], [0.0, 0.0, -0.5]),
                               y_fov=np.pi / 3, aspect=1.0, z_near=0.01)
    for alpha_shadows in (True, False):
        settings = S.PathTracerSettings(max_bounces=1, min_bounces=1, environment_map=False,
                                        luminance_clamp_enabled=False,
                                        alpha_shadows=alpha_shadows)
        imgs = {}
        for dev, (scene, meta) in built.items():
            hops = pt.ALPHA_SHADOW_HOPS
            img, st = pt.trace(scene, meta, settings, S.PathTracerParams(), c2w, FOLIAGE_RES, 5,
                               with_stats=True)
            imgs[str(dev)] = img.cpu().numpy()
            if (pt.ALPHA_SHADOW_HOPS > hops) != alpha_shadows or float(st[1]) != 0.0:
                raise AssertionError(f"foliage on {dev}: alpha-shadow hops or NaN wrong")
        frac, rel, ok = images_match(imgs[str(device)], imgs["cpu"])
        log(f"[foliage] 48x48 alpha_shadows={alpha_shadows} card vs CPU: "
            f"{frac:.5f} of pixels within atol 1e-4 + rtol 1e-3, means {rel:.2e} apart")
        if not ok:
            raise AssertionError("foliage on the card disagrees with the CPU render")


def identical(a, b):
    """Bit-identical (same shape, same 32-bit words)."""
    import torch

    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def phase_warm(device):
    """The warm-up kernel, run first as the bench runs it, then held
    against its plain version and timed. Returns its kernel-table row."""
    import torch

    from gltf_renderer_tpu_torch.ops import warm

    warm.KERNEL_LAUNCHES = 0
    y = warm.warm(device)
    if warm.KERNEL_LAUNCHES != 1 or tuple(y.shape) != warm.WARM_SHAPE:
        raise AssertionError("the warm-up did not launch its kernel once")
    x = torch.randn(warm.WARM_SHAPE, generator=torch.Generator().manual_seed(3)).to(device)
    got, want = warm.add_one(x), warm.warm_ref(x)
    if not identical(got, want):
        raise AssertionError("warm-up kernel disagrees with x + 1")
    # torch.add, kernel, kernel, torch.add: 200 calls back to back each.
    turns = bench_traverse.time_in_turns({"torch.add": lambda: torch.add(x, 1.0),
                                          "add_one": lambda: warm.add_one(x)}, rounds=2, reps=200)
    ms = sum(turns["add_one"]) / 2
    library_ms = sum(turns["torch.add"]) / 2
    plain_ms = cuda_ms(lambda: warm.warm_ref(x), 200)
    b_ms, b_by = bound(nbytes(x, got), x.numel())
    log(f"[warm] add_one {tuple(x.shape)} identical to x + 1; in turns: "
        f"torch.add={turns['torch.add'][0]:.5f} kernel={turns['add_one'][0]:.5f} "
        f"kernel={turns['add_one'][1]:.5f} torch.add={turns['torch.add'][1]:.5f} ms; "
        f"plain={plain_ms:.5f} ms bound={b_ms:.6f} ms ({b_by})")
    return {"name": "add_one", "route": "cuda",
            "source": "gltf_renderer_tpu_torch/csrc/warm.cu", "replaces": WARM_REPLACES,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def brute_bound(rays, tris, n_bytes):
    return bound(n_bytes, OPS_BRUTE_EPILOGUE * rays * tris, OPS_BRUTE_PRODUCTS * rays * tris)


def brute_parent_launcher(ins):
    """A no-argument launch of PARENT_K3's brute_closest_launch (the four
    slabs as they are, abi 1) on `ins`, into fresh outputs, and the outputs;
    or (None, None) when that source is absent."""
    import ctypes

    import torch

    from gltf_renderer_tpu_torch.ops import _build

    if not os.path.exists(PARENT_K3):
        return None, None
    lib = _build.load(PARENT_K3)
    if (lib.brute_closest_abi() if hasattr(lib, "brute_closest_abi") else 1) != 1:
        raise RuntimeError(f"{PARENT_K3} is not a version-1 brute-force kernel")
    fn = lib.brute_closest_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    r, t = ins[0].shape[0], ins[3].shape[1]
    key = torch.empty((r, 1), dtype=torch.int32, device=ins[0].device)
    blk = torch.empty_like(key)
    args = [x.data_ptr() for x in ins] + [r, t, key.data_ptr(), blk.data_ptr()]

    def run():
        if fn(*args, torch._C._cuda_getCurrentRawStream(ins[0].get_device())) != 0:
            raise RuntimeError("the parent brute-force kernel failed to launch")

    return run, (key, blk)


def phase_brute(device):
    """Brute-force kernel vs plain under ops/brute.compare_winners, the old
    kernel in turns where PARENT_K3 holds it, then the study tool's main
    path. Returns its kernel-table row."""
    import torch

    from gltf_renderer_tpu_torch.ops import brute
    from gltf_renderer_tpu_torch.tools import bench_mxu

    rng = np.random.default_rng(11)
    r, t = 16384, 49152
    o = rng.normal(size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tri = [rng.normal(size=(t, 3)).astype(np.float32) * s for s in (1.0, 0.1, 0.1)]
    tmin = np.where(rng.random(r) < 0.2, 0.5, 0.0).astype(np.float32)
    tmax = np.where(rng.random(r) < 0.2, 2.0, 100.0).astype(np.float32)
    cases = [("correctness data", bench_mxu.brute_inputs(*bench_mxu.correctness_data(), device)),
             (f"{r} rays x {t} tris, clipped intervals",
              bench_mxu.brute_inputs(o, d, tmin, tmax, *tri, device)),
             (f"grazing, {r} rays x {t} tris",
              bench_mxu.brute_inputs(*bench_mxu.grazing_data(r, t, seed=13), device))]
    plain, turns, totals = {}, {}, {"rays": 0, "agree": 0}
    worst_dev = 0.0
    for name, ins in itertools.chain(cases, bench_mxu.scale_inputs(device)):
        got = brute.brute_closest(*ins)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = brute.brute_closest_ref(*ins)
        torch.cuda.synchronize()
        plain[name] = (time.perf_counter() - t0) * 1e3
        sample = torch.arange(brute.RAYS_PER_CTA, device=device)
        res = brute.compare_winners(ins, got, want,
                                    sums=(sample, brute.brute_sums(ins[0][sample], *ins[3:])))
        worst_dev = max(worst_dev, res["max_sum_dev"])
        for k in totals:
            totals[k] += res[k]
        share = res["agree"] / res["rays"]
        log(f"[brute] {name} ({ins[0].shape[0]} rays x {ins[3].shape[1]} tris): agree="
            f"{res['agree']} ({share:.6f}) explained={res['explained']} unexplained="
            f"{res['unexplained']} both_hit={res['both_hit']} max_sum_dev="
            f"{res['max_sum_dev']:.3e} (delta {brute.DELTA:.3e}); plain {plain[name]:.3f} ms "
            f"(host clock around one synchronised call)")
        if res["unexplained"] or res["both_hit"] == 0 or res["max_sum_dev"] > brute.DELTA:
            raise AssertionError(f"brute-force kernel breaks its contract on {name}: {res}")
        if not name.startswith("grazing") and share < BRUTE_AGREE_BAR:
            raise AssertionError(f"brute-force kernel agrees on {share:.6f} of {name}")
        if name in dict(bench_mxu.SCALE_WIDTHS).values():
            turns[name] = brute_turns(name, ins, got, device)
    share = totals["agree"] / totals["rays"]
    log(f"[brute] all sets: {totals['agree']} of {totals['rays']} rays agree ({share:.6f})")
    if share < BRUTE_AGREE_BAR:
        raise AssertionError("brute-force kernel agrees on too few rays over all sets")

    brute.KERNEL_LAUNCHES = 0
    refs = brute.REFERENCE_CALLS
    curve, scale = bench_mxu.main(device)
    launches = brute.KERNEL_LAUNCHES
    if launches <= 0 or brute.REFERENCE_CALLS != refs:
        raise AssertionError("the study tool did not run through the brute-force kernel only")
    mm16 = next(tf for k, _, tf in curve if k == 16)
    for row in scale:
        rb_ms, rb_by = brute_bound(row["rays"], row["tris"], row["bytes"])
        row.update(bound_ms=rb_ms, bound_by=rb_by)
        log(f"[brute] tool {row['name']}: {row['rays']} rays x {row['tris']} tris "
            f"kernel={row['ms']:.3f} ms products at {row['product_tflops']:.1f} TFLOP/s "
            f"(torch.mm depth 16: {mm16:.1f}) bound={rb_ms:.4f} ms ({rb_by}) "
            f"bytes={row['bytes']}")
    helmet, court = scale
    log(f"[brute] tool launches={launches}; the kernel table's row is the helmet width")
    return {"name": "brute_closest", "route": "cuda",
            "source": "gltf_renderer_tpu_torch/csrc/brute.cu", "replaces": BRUTE_REPLACES,
            "launches": launches, "max_abs_err": worst_dev, "max_sum_dev": worst_dev,
            "ms": helmet["ms"], "plain_ms": plain[helmet["name"]],
            "bound_ms": helmet["bound_ms"], "bound_by": helmet["bound_by"],
            "library_ms": None, "courtyard_ms": court["ms"],
            "courtyard_plain_ms": plain[court["name"]], "courtyard_bound_ms": court["bound_ms"],
            "product_tflops": helmet["product_tflops"], "mm_k16_tflops": mm16,
            "turns": turns}


def brute_turns(name, ins, got, device):
    """The kernel through its wrapper and, where PARENT_K3 holds the old
    kernel, that kernel's launcher, timed in turns (parent, new, new,
    parent; CUDA events, 2 calls a timing); the old kernel's answer held to
    the new one's by compare_winners. Returns {name: [ms, ms]}."""
    from gltf_renderer_tpu_torch.ops import brute

    fns = {}
    run, out = brute_parent_launcher(ins)
    if run is not None:
        fns["parent"] = run
    fns["kernel"] = lambda: brute.brute_closest(*ins)
    times = bench_traverse.time_in_turns(fns, rounds=2, reps=2)
    log(f"[brute] turns {name}: " + " ".join(f"{k}={[round(x, 3) for x in v]} ms"
                                             for k, v in times.items())
        + " (CUDA events, 2 calls each; kernel through brute_closest)")
    if run is None:
        log(f"[brute] turns: no parent kernel source at {PARENT_K3}, parent not timed")
    else:
        res = brute.compare_winners(ins, got, out)
        log(f"[brute] turns {name}: the parent kernel against this one: {res}")
        if res["unexplained"]:
            raise AssertionError(f"the parent brute-force kernel disagrees on {name}")
    return times


def phase_perlane(device):
    """Per-lane fetch kernels vs plain at the tool's shapes, then the tool's
    main path. Returns their two kernel-table rows."""
    import torch

    from gltf_renderer_tpu_torch.ops import perlane
    from gltf_renderer_tpu_torch.tools import bench_perlane as bp

    rng = np.random.RandomState(5)
    steps = bp.STEPS
    plain = {}
    for label, n, c in bp.SHAPES:
        ids, table = bp.onehot_inputs(rng, n, c, device)
        visited = torch.zeros(n, dtype=torch.bool, device=device)
        got = perlane.onehot_fetch(ids, table, steps)
        want = perlane.onehot_fetch_ref(ids, table, steps, visited=visited)
        s_ids, s_table = bp.shuffle_inputs(rng, n, c, device)
        s_visited = torch.zeros(s_table.shape[0] // c * perlane.LANES, dtype=torch.bool,
                                device=device)
        s_got = perlane.shuffle_fetch(s_ids, s_table, n, c, steps)
        s_want = perlane.shuffle_fetch_ref(s_ids, s_table, n, c, steps, visited=s_visited)
        same = identical(got, want), identical(s_got, s_want)
        log(f"[perlane] {label} ({n}x{c}): onehot identical={same[0]} "
            f"shuffle identical={same[1]}")
        if not all(same):
            raise AssertionError(f"a per-lane fetch kernel disagrees with its plain version "
                                 f"on {label}")
        o_bytes = nbytes(ids, got) + int(visited.sum()) * perlane.SUM_COLS * 2
        s_bytes = nbytes(s_ids, s_got) + int(s_visited.sum()) * c * 4
        plain[label] = {
            "onehot": (cuda_ms(lambda: perlane.onehot_fetch_ref(ids, table, steps), 3),
                       bound(o_bytes, OPS_ONEHOT_LANE_STEP * ids.numel() * steps)),
            "shuffle": (cuda_ms(lambda: perlane.shuffle_fetch_ref(s_ids, s_table, n, c, steps), 3),
                        bound(s_bytes, c * perlane.LANES * steps)),
        }
        if label == PERLANE_ROW:
            log(f"[perlane] device time a call, {label} (torch.profiler, 10 calls): "
                + ", ".join(f"{k} {v:.2f} us" for k, v in {
                    **device_us_by_op(lambda: perlane.onehot_fetch(ids, table, steps)),
                    **device_us_by_op(lambda: perlane.shuffle_fetch(s_ids, s_table, n, c, steps)),
                }.items()))

    perlane.KERNEL_LAUNCHES.update(dict.fromkeys(perlane.KERNEL_LAUNCHES, 0))
    refs = perlane.REFERENCE_CALLS
    rows = bp.main(device)
    launches = dict(perlane.KERNEL_LAUNCHES)
    if min(launches.values()) <= 0 or perlane.REFERENCE_CALLS != refs:
        raise AssertionError("the study tool did not run through the per-lane kernels only")
    out = {}
    for row in rows:
        p_ms, (b_ms, b_by) = plain[row["label"]][row["kind"]]
        floor_ms = row["latency_floor_ms"]
        log(f"[perlane] tool {row['kind']} {row['label']}: kernel={row['ms']:.4f} ms "
            f"({row['us_step']:.3f} us/step) plain={p_ms:.3f} ms bound={b_ms:.6f} ms ({b_by}); "
            f"latency floor {floor_ms:.6f} ms ({bp.STEPS} dependent loads, at most "
            f"{row['l1_hit_ceiling']:.3f} of them L1 hits, the rest L2 hits), "
            f"kernel / max(bound, floor) = {row['ms'] / max(b_ms, floor_ms):.2f}")
        if row["label"] == PERLANE_ROW:
            out[row["kind"]] = {"ms": row["ms"], "plain_ms": p_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "latency_floor_ms": floor_ms,
                                "l1_hit_ceiling": row["l1_hit_ceiling"]}
    log(f"[perlane] tool launches={launches}; the kernel table's rows are the {PERLANE_ROW} "
        f"shape")
    common = {"route": "cuda", "source": "gltf_renderer_tpu_torch/csrc/perlane.cu",
              "max_abs_err": 0.0, "library_ms": None}
    return [dict(common, name="onehot_fetch", replaces=ONEHOT_REPLACES,
                 launches=launches["onehot_fetch"], **out["onehot"]),
            dict(common, name="shuffle_fetch", replaces=SHUFFLE_REPLACES,
                 launches=launches["shuffle_fetch"], **out["shuffle"])]


def phase_bench(scene_kind="helmet", steps=3):
    """The port's bench entry point as a user runs it. Returns its detail."""
    import subprocess

    env = dict(os.environ, BENCH_WIDTH=str(FULL_RES[0]), BENCH_HEIGHT=str(FULL_RES[1]),
               BENCH_STEPS=str(steps), BENCH_SCENE=scene_kind)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gltf_renderer_tpu_torch.bench"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"[bench:stderr] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the bench exited with {proc.returncode}")
    lines = proc.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} lines on stdout, not 1")
    result = json.loads(lines[0])
    detail = next(json.loads(x)["detail"] for x in reversed(proc.stderr.splitlines())
                  if x.startswith('{"detail"'))
    log(f"[bench] {scene_kind} {wall:.1f}s wall: {lines[0]}")
    helmet = scene_kind == "helmet"
    metric = "pt_mrays_per_s_per_chip_1080p" if helmet else f"pt_mrays_per_s_{scene_kind}_1080p"
    if (result.get("metric") != metric or not result["value"] > 0
            or detail["gates"]["nan_pixels_zero"] is not True
            or (helmet and (detail["gates"]["ssim_ge_0995"] is not True
                            or not (detail["raster_fps"] or 0) > 0))):
        raise AssertionError(f"the bench's result fails its checks: {result} {detail}")
    launches = detail["kernel_launches"]
    if launches["add_one"] != 1 or launches["traverse_wide"] <= 0:
        raise AssertionError(f"the bench did not run through its kernels: {launches}")
    return detail


def brute_sass():
    """Opcode counts of the brute-force kernel's SASS (cuobjdump -sass of
    its library): {opcode: count} for the closest-hit kernel. Raises when
    the kernel has no HGMMA (wgmma) instruction."""
    import re
    import subprocess

    from gltf_renderer_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.library_path("brute.cu")], check=True,
                          capture_output=True, text=True, timeout=60).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass)[1:]
                if f.startswith("_Z") and "ILb0E" in f.split("\n")[0])
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
    counts = {op: ops.count(op) for op in sorted(set(ops))}
    if not counts.get("HGMMA"):
        raise AssertionError("the brute-force kernel has no wgmma (HGMMA) instruction")
    return counts


def build_kernels():
    """Build every kernel library at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    from gltf_renderer_tpu_torch.ops import _build

    sources = SOURCES + tuple(p for p in (PARENT_K1, PARENT_K2, PARENT_K3)
                              if os.path.exists(p))
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.load, sources))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from gltf_renderer_tpu_torch import device as dev_mod
    from gltf_renderer_tpu_torch.bench_scene import build_bench_scene
    from gltf_renderer_tpu_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = dev_mod.card_name_and_power_limit()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build_kernels()
    log(f"[build] {', '.join(_build.library_path(x) for x in SOURCES)} in "
        f"{time.perf_counter() - t0:.2f}s")
    for source in SOURCES:
        for line in _build.ptxas_report(source):
            log(f"[ptxas] {source}: {line.strip()}")
    ops = brute_sass()
    log(f"[sass] brute.cu closest-hit kernel, static opcode counts (one tile's 32 pairs a "
        f"thread): " + ", ".join(f"{k} {ops.get(k, 0)}" for k in (
            "HGMMA", "FSETP", "FADD", "FMUL", "VOTE", "MUFU", "FCHK", "CALL", "BRA")))

    warm_row = phase_warm(device)

    t0 = time.perf_counter()
    scene, meta, settings, params, c2w, n_tris = build_bench_scene(*FULL_RES, device=device)
    log(f"[scene] {n_tris} triangles, stack bound {meta.stack_bound}, "
        f"{scene.wide_nodes.shape[0]} wide nodes, {scene.leaf_records.shape[0]} leaves, "
        f"built in {time.perf_counter() - t0:.2f}s")

    worst_abs, times = phase_kernel_vs_plain(scene, meta, params, c2w, device)
    phase_fidelity(scene, meta, settings, params)
    launches, mrays, _ = phase_main_path(scene, meta, settings, params, c2w, card)
    k2 = phase_raster_kernel(scene)
    phase_raster_fidelity(device)
    frames = phase_raster_frame(scene, meta, params, c2w, card)
    log(f"[done] phases 1-7 in {time.perf_counter() - t_start:.1f}s")
    t0 = time.perf_counter()
    court = phase_courtyard(device, card)
    log(f"[done] phase 7b in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    brute_row = phase_brute(device)
    perlane_rows = phase_perlane(device)
    log(f"[done] phases 8-9 in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    bench_detail = phase_bench()
    court_detail = phase_bench("courtyard", steps=2)
    log(f"[done] phase 10 in {time.perf_counter() - t0:.1f}s; all phases in "
        f"{time.perf_counter() - t_start:.1f}s")
    log(f"[courtyard] bench alpha hops {court_detail['alpha_hops']}, traversal launches "
        f"{court_detail['kernel_launches']['traverse_wide']}")
    lane = times["lane_mixed"]
    c_lane = court["k1"]["lane_mixed"]
    c_k2 = court["k2"]
    print(json.dumps({"kernels": [{
        "name": "traverse_wide", "route": "cuda",
        "source": "gltf_renderer_tpu_torch/csrc/traverse.cu", "replaces": REPLACES,
        "launches": launches + court["launches"],
        "max_abs_err": max(worst_abs, *(x["max_abs"] for x in court["k1"].values())),
        "ms": lane["ms"], "plain_ms": lane["plain_ms"], "bound_ms": lane["bound_ms"],
        "bound_by": lane["bound_by"], "library_ms": None, "launcher_ms": lane["launcher_ms"],
        "courtyard_ms": c_lane["ms"], "courtyard_plain_ms": c_lane["plain_ms"],
        "courtyard_bound_ms": c_lane["bound_ms"], "courtyard_bound_by": c_lane["bound_by"],
    }, {
        "name": "raster_tiles", "route": "cuda",
        "source": "gltf_renderer_tpu_torch/csrc/raster.cu", "replaces": RASTER_REPLACES,
        "launches": frames["tiled"][1], "max_abs_err": max(k2["err"], c_k2["err"]),
        "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None, "bound_all_px_ms": k2["bound_all_px_ms"],
        "launcher_ms": k2["launcher_ms"], "parent_launcher_ms": k2["parent_ms"],
        "courtyard_ms": c_k2["ms"], "courtyard_plain_ms": c_k2["plain_ms"],
        "courtyard_bound_ms": c_k2["bound_ms"], "courtyard_bound_by": c_k2["bound_by"],
        "courtyard_bound_all_px_ms": c_k2["bound_all_px_ms"],
        "courtyard_launcher_ms": c_k2["launcher_ms"],
        "courtyard_parent_launcher_ms": c_k2["parent_ms"],
    }, brute_row, *perlane_rows,
        dict(warm_row, launches=bench_detail["kernel_launches"]["add_one"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
