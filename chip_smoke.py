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
   cull/blend mode at 256x144, at the kernel table's two launch sizes
   (262,144 primary and 524,288 lane-mixed rays) and, untimed, at the path
   tracer's own (pathtracer.RAY_CHUNK primary and 2 x RAY_CHUNK lane-mixed
   rays, a spp-4 1080p chunk's launches) (t, u, v and word identical on
   every lane), and both timed at the table's sizes: the wrapper the path
   tracer calls (the kernel table's `ms`), and
   the kernel's C launcher on ready tensors in turns (`launcher_ms`); where
   build/parent/traverse.cu holds an older kernel source (copied there by
   hand; build/ is not committed), its launcher is built too and timed in
   the same turns;
3. path-tracer fidelity: the 256x144 probe (mean of seeds 1..32) against the
   committed CPU golden tests/goldens/bench_fidelity.npy by SSIM (bar
   0.995), no NaN/Inf;
4. the path tracer at full size: 1920x1080, trace_chunked(spp=4), one warm
   step and two timed steps, with the kernel launch counters reset first;
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
   0; the port's GLB through Renderer.load_scene(path)) in both
   visibilities, against the committed CPU golden
   tests/goldens/helmet_raster.png by SSIM (bar 0.99);
7. the raster frame at full size: bench scene, 1920x1080, raycast
   visibility + bloom + AgX -> u8, one warm and two timed frames, then the
   same with tiled visibility; the traversal kernel launches once a chunk
   of a raycast frame, the tile kernel once a tiled frame, and no plain
   version runs;
7b. the courtyard (alpha MASK, alpha shadows, punctual lights): the
   courtyard bench scene built at 1920x1080; the traversal kernel vs its
   plain version on its tables for primary and lane-mixed rays at the
   kernel table's two launch sizes, timed through its wrapper, and at the
   path tracer's own, untimed (t, u, v and word identical); phase 5's tile-kernel check on its bench view; the courtyard
   golden configuration (128x72, two accumulated frames, tone mapped)
   against tests/goldens/courtyard_pt.png by SSIM (bar 0.99); the foliage
   scene (masked leaf, point light) at 48x48 with alpha shadows on and off,
   card against CPU at the CPU tests' bar; then the 1080p courtyard step,
   trace_chunked(spp=4), one warm and two timed steps, with every traversal
   launch accounted for (3 a chunk plus one a retry or alpha-shadow hop)
   and no plain version run;
7c. the material zoo (sheen, clearcoat, thin transmission on a
   BLEND-flagged sphere, anisotropic metal, an emissive floor) built at
   1920x1080: the traversal kernel vs its plain version on its tables for
   primary and lane-mixed rays at the kernel table's two launch sizes (t,
   u, v and word identical), timed through its wrapper; the materials golden
   configuration (160x120, eight accumulated frames, tone mapped) against
   tests/goldens/materials_pt.png by SSIM (bar 0.99); the zoo at 64x48,
   card against CPU at the CPU tests' bar, in the MIS, diffuse-white and
   non-MIS modes and for the five debug outputs read after the first BSDF
   sample; then the 1080p zoo step as 7b's, one warm and two timed steps,
   every traversal launch accounted for and no plain version run;
7d. the raster backend's full pass (blend and transmission, clearcoat IBL,
   punctual lights, the masked retry, motion vectors): the zoo's raster
   build at 1920x1080; the traversal kernel vs its plain version on 262,144
   pixel rays of its raster view (the chunk holding the image centre) on
   its tables, with the opaque pass's BLEND_EXCLUDE and the blend pass's
   first BLEND_ONLY launch (t, u, v and word identical), timed through its
   wrapper; the box-raster golden configuration (256x256, one point light,
   no environment) in both visibilities against tests/goldens/box_raster.png
   by SSIM (bar 0.99); the zoo and the courtyard at 64x48 rasterized in
   both visibilities, card against CPU at the CPU tests' bar; the zoo and
   the courtyard rasterized at 1920x1080 in both visibilities, one warm and
   two timed frames each, with draw and post times, every traversal and
   tile launch accounted for (a raycast frame: one a chunk, one a retry
   hop, 4 a chunk in the blend pass; a tiled frame: the same but the
   first, and one tile launch) and no plain version run; motion vectors on
   the zoo at 1080p from a moved camera, finite and 0 on background pixels;
7e. the loader, environment IO and animation: the bench's analytic sky at
   2048x1024 written as .hdr and as .exr ZIP float and a 256x128 crop as
   .exr PIZ half, read back by read_environment_image (ZIP and PIZ
   bit-identical, RGBE within 2^-8 of the maximum) with every PIZ block
   decoded by the native decoder; build_environment (cube 128) on the card
   and again from its cache (bit-identical); the courtyard written as a
   GLB (tex_size 256) and read by the port's loader, every table
   bit-identical to the in-memory courtyard, built through make_pt_scene
   and run for one 1080p step with every traversal launch accounted for;
   the skinned strips (64 skins) and the morph cube read by the loader,
   8 frames of 1/30 s each at 1080p spp=4 (animate, skinning, world
   rebuild and BVH refit on the card, trace), with per frame the refit
   boxes equal to a CPU refit and holding their triangles and children,
   the traversal kernel bit-identical to its plain version on 262,144
   primary rays of the refitted tables, exactly 96 launches a frame and
   the skin_and_refit and trace times (CUDA events); after the 8th frame
   every pixel ray's closest t equal to a fresh build's at the same pose
   (differing ids, on exact-t ties, counted); one raster frame of the
   strips in each visibility (8 traversal launches raycast, 1 tile launch
   tiled); and the anim_pose golden (render_anim_pose_golden) against
   tests/goldens/anim_pose.png by SSIM (bar 0.99);
7f. the Renderer, the CLI and the viewer (the five golden configurations,
   each written by the port's writers and drawn through
   Renderer.load_scene(path) as tests/golden_configs.py configures the JAX
   renderer, are drawn once each in phases 6, 7b, 7c, 7d and 7e, and their
   SSIMs logged together after 7f): on phase 7e's courtyard GLB at
   1920x1080 under phase 7e's environment, the save / load round trip (two
   frames, save_state, the third; a fresh Renderer's first frame after
   load_state identical to it, u8 and HDR), then one warm and two timed
   path-tracer frames with profile on (frame_ms, pass_ms, every traversal
   launch accounted for: 3 a chunk plus one a retry or alpha-shadow hop;
   rays per second beside phase 7b's step) and one warm and two timed
   raster frames (one traversal launch a chunk plus one a retry hop, no
   tile launch); the CLI as four subprocesses at once (`python -m
   gltf_renderer_tpu_torch.app.cli`): the courtyard at 1920x1080 path
   traced (spp 4) and rasterized under the .hdr sky, rc 0 and a PNG of the
   right shape with nonzero std each, three numbered frames of the
   animated strips that differ, rc 1 for a missing file; the viewer
   (`app.viewer.serve` on a loopback port) on the strips at 960x540: an
   orbit, a debug-output `set`, a backend toggle and an animation
   transport input, each seen in /state and followed by a newer
   /frame.png, then shut down with its render thread;
7g. multi-device rendering (parallel/sharding.py) and the rest of the
   port, inside 7f's temporary directory: (a) in this process, with no
   process group, the courtyard GLB path traced (7f's settings) and the
   material zoo rasterized (raycast; its transmissive sphere puts the
   backdrop gather on the path) at 1920x1080 under 7e's environment, two
   frames each unsharded and through Renderer(mesh=make_mesh(1, 4)),
   identical in u8 and HDR, every traversal launch accounted for (3 a
   chunk of each cell + one a hop; 5 a chunk of the raster region); the
   courtyard's first frame through a 2 x 2 mesh against the mean of its
   two seeds' unsharded samples; (b) two ranks spawned on this card in a
   gloo group (file store), each loading the GLB, the zoo and the
   environment (from 7e's cache) itself and drawing the same frames
   through Renderer(mesh="auto"), identical to (a), each rank's launches
   accounted for and its wall and collective ms logged; both are joined
   within SHARD_RANK_DEADLINE_S or killed, and the run fails; (c) an nccl
   group of world 1 in this process, one sharded frame identical to
   (a)'s; (d) the host-binned rasterize (ops/raster.rasterize) at
   1920x1080 on the helmet's and the courtyard's bench views: one tile
   launch a call, the tile kernel on the host-built lists bit-identical
   to its plain version, the pixels differing from rasterize_device all
   on near-clipped triangles, the host stages' and the kernel's ms; (e)
   the hop-bound scene (scene.procedural.write_alpha_stack_gltf) on the
   card: the masked retries and alpha shadows through the traversal
   kernel equal to the same calls on the CPU, and the bounded results
   tests/test_torch_hop_bounds.py pins for every N. In (b) and (c) the
   closing status exchange of a sharded Renderer frame is timed in turns
   (frames without it, Renderer._frame, and with it, draw_frame) beside
   20 lone exchanges;
7h. BASELINE config 5's tool (`python -m
   gltf_renderer_tpu_torch.tools.render_config5`: the courtyard GLB at
   density 1, 2 bounces, alpha shadows, the bench's analytic sky, the K6
   warm-up first) at 1920x1080 as a user runs it: two subprocess sessions
   into one directory (--frames 3 --ckpt-every 3, then --frames 6
   resuming from its checkpoint), against one uninterrupted 6-frame
   session of the tool's main in this process with the launch counters
   reset first: the checkpoint's accumulation bits, the u8 PNG, spp and
   frame index identical; every traversal launch accounted for (3 a
   chunk plus one a retry or alpha-shadow hop, in this process and as
   each session's progress file counts them), one warm-up launch, no
   plain version run; seconds a sample, K1 launches and hops a frame;
7i. courtyard2, the bench's 1,096,576-triangle courtyard (density 2),
   inside 7f's temporary directory: its bench build at 1920x1080 (triangles,
   stack bound, wide nodes, leaves, build seconds, max_memory_allocated);
   the traversal kernel vs its plain version on its tables for primary and
   lane-mixed rays at the kernel table's two launch sizes (t, u, v and word
   identical), timed with its bound; the tile kernel vs its plain version
   on its bench view (bit-identical, crossers beside CLIP_CAP), timed; the
   1080p step as 7b's, one warm and two timed steps, every traversal
   launch accounted for; the courtyard golden configuration's 128x72
   window of courtyard2 (tex_size 64, 2 bounces, alpha shadows, seeds 0
   and 1) on the card against the CPU at the CPU tests' bar; its GLB
   written and drawn through Renderer.load_scene(path) under 7e's
   environment, one 1080p frame path traced (spp 1, the tables built in
   it), rasterized raycast and tiled, every traversal and tile launch
   accounted for; then the port's bench with BENCH_SCENE=courtyard2 and
   two steps;
7j. the furnace check of tests/test_ssim_baseline.py at 1920x1080: the
   diffuse box under a uniform environment rasterized and path traced to
   FURNACE_SPP samples (4 bounces, through trace_chunked at the main
   path's launch size), windowed SSIM >= 0.99 after a 4x4 downsample and
   the means within 2%, with the spp and seconds logged;
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
   bit-identical at the tool's three table shapes (plain versions timed);
   both kernels' study (`tools.bench_perlane.study`): each kernel's
   output held to the plain version and its device time a call (CUDA-graph
   replay, and torch.profiler's with the launches it recorded) at all three
   shapes, in turns with the older kernel where build/parent/perlane.cu
   holds its source (parent, new, new, parent), a steps sweep at 6400x112
   with each kernel's fitted slope and intercept beside the warm-up
   kernel's graph time, the SM clock idle and under load, and the SASS
   opcode counts; then `python -m
   gltf_renderer_tpu_torch.tools.bench_perlane`'s main with the launch
   counters reset: its pointer chases measure the card's L1, L2 and
   shared-memory hit latencies, and each kernel's latency floor (32
   dependent loads, in place with as many L1 hits as its chains allow and
   L2 hits for the rest, or staged in shared memory after one L2 round
   trip, whichever is less) is logged beside its byte bound (the kernels
   line's `latency_floor_ms`; its `ms` is the tool's launch-bound 16-call
   time, `device_ms` the graph device time a call);
10. the port's bench entry point, `python -m gltf_renderer_tpu_torch.bench`,
   as a subprocess at 1920x1080 with BENCH_STEPS=2: one JSON line on
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
import tempfile
import time

import numpy as np

from gltf_renderer_tpu_torch.device import cuda_ms, device_us_by_op
from gltf_renderer_tpu_torch.tools import bench_traverse

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "bench_fidelity.npy")
RASTER_GOLDEN = os.path.join(ROOT, "tests", "goldens", "helmet_raster.png")
COURTYARD_GOLDEN = os.path.join(ROOT, "tests", "goldens", "courtyard_pt.png")
MATERIALS_GOLDEN = os.path.join(ROOT, "tests", "goldens", "materials_pt.png")
FULL_RES = (1920, 1080)
SPP = 4
TIMED_STEPS = 2
COURTYARD_TIMED_STEPS = 2
MATERIALS_TIMED_STEPS = 2
MATERIALS_TRIS = 4 * 2208 + 2  # four 24x48 UV spheres and a floor quad
MATERIALS_CHECK_RES = (64, 48)
RASTER_CHECK_RES = (64, 48)  # the zoo and the courtyard rasterized, card vs CPU
RASTER_CHECK_DIFFUSE = 16    # their diffuse prefilter's size on both devices
RASTER_TIMED_FRAMES = 2
BOX_GOLDEN = os.path.join(ROOT, "tests", "goldens", "box_raster.png")
MOVED_ZOO_EYE = [0.2, -6.1, 3.05]  # phase 7d's motion-vector camera, at the zoo's target
FOLIAGE_RES = (48, 48)
SKY_HW = (1024, 2048)       # phase 7e's environment image, the bench's analytic sky
PIZ_CROP_HW = (128, 256)    # its PIZ half crop (the PIZ writer is pure-Python Huffman)
ENV_CUBE = 128
ANIM_FRAMES = 8
ANIM_DELTA = 1.0 / 30.0
ANIM_STRIPS = 64
ANIM_GOLDEN = os.path.join(ROOT, "tests", "goldens", "anim_pose.png")
APP_TIMED_PT = 2       # phase 7f: the Renderer's timed 1080p path-tracer frames
APP_TIMED_RASTER = 2   # and raster frames, each after one warm frame
CLI_TIMEOUT_S = 300
VIEWER_DEADLINE_S = 60
SHARD_MESH = (1, 4)          # phase 7g (a): four row tiles drawn in turn by one process
SHARD_FRAMES = 2             # frames a renderer draws in 7g (a) and (b)
SHARD_RANK_DEADLINE_S = 120  # 7g (b): the two ranks are killed, and the run fails, past it
COURTYARD2_TRIS = 1096576  # the courtyard at density 2
COURTYARD2_TIMED_STEPS = 2  # phase 7i's 1080p steps after one warm, and its bench's steps
FURNACE_SPP = 64  # phase 7j's samples a pixel: the fewest that meet the furnace bar
CONFIG5_SESSIONS = (3, 6)  # phase 7h: the tool's two sessions' targets (spp), one directory
CONFIG5_CKPT_EVERY = 3
CONFIG5_TIMEOUT_S = 300
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
PARENT_PERLANE = os.path.join(ROOT, "build", "parent", "perlane.cu")  # optional, for phase 9's turns
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

    # Times at the kernel table's launch sizes: 262144 primary rays and
    # 2 x 262144 merged bounce + shadow rays.
    big = bench_traverse.ray_sets(scene, meta, params, c2w, bench_traverse.RAYS_RES, device)
    times = {}
    for rays in (big[0], big[2]):
        row = k1_main_size(scene, meta, rays, "[kernel]")
        worst_abs = max(worst_abs, row["max_abs"])
        row["launcher_ms"] = launcher_turns(scene, meta, rays)
        times[rays[0]] = row
    del big
    return worst_abs, times, k1_chunk_size(scene, meta, params, c2w, device, "[kernel]")


def k1_chunk_size(scene, meta, params, c2w, device, tag):
    """K1 against its plain version at the path tracer's own launch sizes:
    pathtracer.RAY_CHUNK primary rays and 2 x RAY_CHUNK lane-mixed rays, as
    one chunk of a spp-4 1080p step launches them (t, u, v and word
    identical, or raise). The plain version runs once, untimed. Returns the
    ray counts checked."""
    import torch

    from gltf_renderer_tpu_torch.render import pathtracer as pt

    sets = bench_traverse.ray_sets(scene, meta, params, c2w, (2048, pt.RAY_CHUNK // 2048),
                                   device)
    checked = []
    for rays in (sets[0], sets[2]):
        frac, _, max_rel, same = compare(scene, meta, rays, 0, 0)
        log(f"{tag} chunk size {rays[0]:10s} rays={rays[1].shape[0]} word_agree={frac:.6f} "
            f"max_rel_tuv={max_rel:.3e} identical={same}")
        if not same:
            raise AssertionError(f"kernel disagrees with plain version on {rays[0]} at the "
                                 "path tracer's chunk size")
        checked.append(rays[1].shape[0])
    if checked != [pt.RAY_CHUNK, 2 * pt.RAY_CHUNK]:
        raise AssertionError(f"chunk-size ray sets hold {checked} rays")
    del sets
    torch.cuda.empty_cache()
    return checked


def k1_main_size(scene, meta, rays, tag, blend=0):
    """K1 against its plain version on one main-path-size ray set under the
    blend filter `blend` (t, u, v and word identical, or raise), then timed
    through its wrapper, the plain version timed, and the bound from the
    visits this data needs. Returns {n, ms, plain_ms, bound_ms, bound_by,
    max_abs}."""
    from gltf_renderer_tpu_torch.ops import traverse as tr

    frac, max_abs, max_rel, same = compare(scene, meta, rays, 0, blend)
    _, o, d, tmn, tmx, mode = rays
    log(f"{tag} {rays[0]:10s} blend={blend} rays={o.shape[0]} word_agree={frac:.6f} "
        f"max_rel_tuv={max_rel:.3e} identical={same}")
    if not same:
        raise AssertionError(f"kernel disagrees with plain version on {rays[0]} (main-path size)")
    args = bench_traverse.wrapper_args(scene, meta, rays)
    args = args[:11] + (blend,) + args[12:]
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
    chunks = stream_chunks(w, h, pt.RAY_CHUNK // SPP)
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
        + ", ".join(f"{k} {us:.2f} us ({n} launches recorded)" for k, (us, n) in device_us_by_op(
            lambda: raster.rasterize_tiles(*args, cull_sign=1)).items()))
    return dict(out, ms=ms_k, plain_ms=start.elapsed_time(end), bound_ms=b_ms, bound_by=b_by,
                bound_all_px_ms=all_ms, launcher_ms=statistics.median(turns["new"]),
                parent_ms=turns.get("parent"))


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
    """The helmet-raster golden through the Renderer (the port's GLB, one
    fresh Renderer a visibility under one environment build) against
    tests/goldens/helmet_raster.png. Returns the two SSIMs."""
    import torch

    from PIL import Image

    from gltf_renderer_tpu_torch.bench_scene import analytic_equirect, helmet_raster_renderer
    from gltf_renderer_tpu_torch.env.environment import build_environment
    from gltf_renderer_tpu_torch.ops import raster
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    env = build_environment(analytic_equirect(), device=device)
    golden = np.asarray(Image.open(RASTER_GOLDEN))
    scores = {}
    for vis in ("raycast", "tiled"):
        r = helmet_raster_renderer(device, env)
        r.raster_visibility = vis
        img = r.draw_frame()
        if img.shape != golden.shape or not bool(torch.isfinite(r._accum).all()):
            raise AssertionError(f"raster fidelity {vis}: shape {img.shape} or non-finite HDR")
        scores[vis] = ssim(img, golden)
        diff = np.abs(img.astype(np.int16) - golden.astype(np.int16))
        log(f"[raster-fidelity] {vis} {img.shape[1]}x{img.shape[0]} through "
            f"Renderer.load_scene(path): ssim={scores[vis]:.6f} (bar {RASTER_SSIM_BAR}) u8 "
            f"within 1: {(diff <= 1).all(-1).mean():.5f} max diff {int(diff.max())}")
    world = r._ptscene.world
    ins = raster.prepare_tiles(world.position, world.tri_vertex, r.camera.world_to_clip(),
                               r.settings.width, r.settings.height,
                               double_sided=world.tri_double_sided)
    log(f"[raster-fidelity] pairs={int(ins.n_pairs)}/{ins.pair_cap} "
        f"crossers={int(ins.n_cross)}/{ins.clip_cap}")
    if scores["raycast"] < RASTER_SSIM_BAR or scores["tiled"] < RASTER_SSIM_BAR:
        raise AssertionError(f"raster fidelity below the bar: {scores}")
    return scores


def phase_raster_frame(scene, meta, params, c2w, card):
    """The helmet's raster frame at 1080p in both visibilities
    (`raster_frames`), then the tiled visibility's set-up timed. Returns
    raster_frames' counts."""
    from gltf_renderer_tpu_torch import camera
    from gltf_renderer_tpu_torch.ops import raster
    from gltf_renderer_tpu_torch.render import settings as S

    w, h = FULL_RES
    rs = S.RenderSettings(backend="rasterizer", width=w, height=h)
    cam_pos = np.asarray([1.1, -1.1, 0.6], np.float32)  # the bench camera's eye
    out = raster_frames("helmet", (scene, meta, rs, params, c2w, cam_pos, (w, h)), card,
                        TIMED_STEPS)
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


def stream_chunks(w, h, chunk):
    """`chunk`-pixel chunks of a w x h frame's tile-order stream: the raster
    frame's slices (rasterizer.RASTER_CHUNK) or the path tracer's
    _trace_rays calls (pathtracer.RAY_CHUNK // spp pixels each)."""
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    n = -(-h // pt.PACKET_TILE) * -(-w // pt.PACKET_TILE) * pt.PACKET_TILE ** 2
    return -(-n // chunk)


def centre_chunk_rays(c2w, dev):
    """(origin, direction, ray length) of one RASTER_CHUNK of 1080p
    pixel-centre rays in tile order, the chunk holding the image centre."""
    import torch

    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import rasterizer as rz

    w, h = FULL_RES
    px, py, _ = pt._tile_order(w, h, dev)
    centre = int(torch.nonzero((px == w // 2) & (py == h // 2))[0, 0])
    k = centre // rz.RASTER_CHUNK
    sl = slice(k * rz.RASTER_CHUNK, (k + 1) * rz.RASTER_CHUNK)
    return rz._pixel_rays(px[sl], py[sl], (w, h), torch.as_tensor(c2w, device=dev))


def raster_rays(scene, meta, c2w):
    """The raster pass's two traversal launches on one chunk of 1080p pixel
    rays, the chunk holding the image centre: the opaque pass's
    (BLEND_EXCLUDE, t_max the ray length) and the blend pass's first
    (BLEND_ONLY, t_max the opaque hit's t). (name, origin, direction, t_min,
    t_max, mode) sets as bench_traverse.ray_sets gives them."""
    import torch

    from gltf_renderer_tpu_torch.ops import bvh as bvh_ops
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    o, d, t_max = centre_chunk_rays(c2w, scene.world.position.device)
    zero = torch.zeros_like(t_max)
    opaque = pt.closest_hit(scene, meta, o, d, zero, t_max, blend_mode=bvh_ops.BLEND_EXCLUDE)
    t_far = torch.minimum(torch.where(opaque.tri >= 0, opaque.t, float("inf")), t_max)
    return ("raster_opaque", o, d, zero, t_max, None), ("raster_blend", o, d, zero, t_far, None)


def raster_frames(tag, built, card, timed):
    """One warm and `timed` timed raster frames of the raster build `built`
    in both visibilities, draw and post timed, launch counters reset first:
    every traversal launch is a chunk's opaque launch (raycast), a retry
    hop or one of a chunk's MAX_BLEND_LAYERS blend launches, every tile
    launch one a tiled frame, and no plain version runs. Returns
    {visibility: (K1 launches, K2 launches, retry hops a frame, draw
    seconds, post seconds)}."""
    import torch

    from gltf_renderer_tpu_torch.ops import raster
    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import rasterizer as rz
    from gltf_renderer_tpu_torch.render import renderer

    scene, meta, rs, params, c2w, cam_pos, (w, h) = built
    chunks = stream_chunks(w, h, rz.RASTER_CHUNK)
    out = {}
    for vis in ("raycast", "tiled"):
        tr.KERNEL_LAUNCHES = raster.KERNEL_LAUNCHES = rz.RASTER_RETRY_HOPS = 0
        refs = (tr.REFERENCE_CALLS, raster.REFERENCE_CALLS)
        draw_s, post_s, hops = [], [], []
        for i in range(timed + 1):
            hops0 = rz.RASTER_RETRY_HOPS
            t0 = time.perf_counter()
            hdr = renderer.raster_step(scene, meta, rs, params, c2w, cam_pos, (w, h), i,
                                       visibility=vis)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            img = renderer.post_step(hdr, rs.tonemap, rs.bloom, i)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            hops.append(rz.RASTER_RETRY_HOPS - hops0)
            if i:
                draw_s.append(t1 - t0)
                post_s.append(t2 - t1)
        frames = timed + 1
        k1, k2 = tr.KERNEL_LAUNCHES, raster.KERNEL_LAUNCHES
        per_frame = chunks * ((vis == "raycast") + rz.MAX_BLEND_LAYERS * meta.has_blend)
        log(f"[raster-frame] {tag} {vis} {w}x{h} draw={[round(x * 1e3, 3) for x in draw_s]} ms "
            f"post={[round(x * 1e3, 3) for x in post_s]} ms traverse_launches={k1} "
            f"raster_launches={k2} retry_hops={hops} frames={frames} "
            f"({per_frame} traverse launches a frame without hops) card={card}")
        if tuple(img.shape) != (h, w, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"{tag} {vis}: wrong output {tuple(img.shape)} {img.dtype}")
        if not bool(torch.isfinite(hdr).all()):
            raise AssertionError(f"{tag} {vis}: non-finite HDR values")
        if (tr.REFERENCE_CALLS, raster.REFERENCE_CALLS) != refs:
            raise AssertionError(f"{tag} {vis} ran a plain version")
        if k1 != per_frame * frames + sum(hops) or k2 != frames * (vis == "tiled"):
            raise AssertionError(f"{tag} {vis}: {k1} traversal and {k2} tile launches in "
                                 f"{frames} frames, {per_frame} a frame plus {sum(hops)} hops "
                                 f"and {frames * (vis == 'tiled')} expected")
        out[vis] = (k1, k2, hops, draw_s, post_s)
    return out


def phase_raster_blend(device, card):
    """The raster backend's full pass on the card (phase 7d). Returns the
    traversal kernel's raster numbers and the 1080p frames' counts."""
    import torch

    from PIL import Image

    from gltf_renderer_tpu_torch import camera
    from gltf_renderer_tpu_torch.bench_scene import (
        MATERIALS_VIEW,
        build_raster_scene,
        render_box_raster_golden,
    )
    from gltf_renderer_tpu_torch.ops import bvh as bvh_ops
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import rasterizer as rz
    from gltf_renderer_tpu_torch.render import renderer
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    t0 = time.perf_counter()
    zoo = build_raster_scene("materials", *FULL_RES, device=device)
    scene, meta = zoo[0], zoo[1]
    log(f"[raster-blend] zoo raster build {time.perf_counter() - t0:.2f}s: "
        f"has_blend={meta.has_blend} has_clearcoat={meta.has_clearcoat} "
        f"has_transmission={meta.has_transmission} ggx levels={len(scene.env.ggx)}")
    if not (meta.has_blend and meta.has_clearcoat and meta.has_transmission and scene.env.ggx):
        raise AssertionError("the zoo's raster build is not the zoo with prefilters")

    # K1 at the raster's launch size, with both blend filters.
    opaque_rays, blend_rays = raster_rays(scene, meta, zoo[4])
    k1 = {"raster_opaque": k1_main_size(scene, meta, opaque_rays, "[raster-blend] kernel",
                                        blend=bvh_ops.BLEND_EXCLUDE),
          "raster_blend": k1_main_size(scene, meta, blend_rays, "[raster-blend] kernel",
                                       blend=bvh_ops.BLEND_ONLY)}

    # The box-raster golden, through the Renderer.
    golden = np.asarray(Image.open(BOX_GOLDEN))
    box_ssim = {}
    for vis in ("raycast", "tiled"):
        img = render_box_raster_golden(device, vis)
        score = box_ssim[vis] = ssim(img, golden) if img.shape == golden.shape else 0.0
        log(f"[raster-blend] box-raster golden {vis} through Renderer.load_scene(path): "
            f"ssim={score:.6f} (bar {RASTER_SSIM_BAR})")
        if score < RASTER_SSIM_BAR:
            raise AssertionError(f"the box-raster golden fails its bar ({vis})")

    # The zoo and the courtyard at 64x48, card against CPU.
    for kind in ("materials", "courtyard"):
        built = {dev: build_raster_scene(kind, *RASTER_CHECK_RES, device=dev,
                                         diffuse_size=RASTER_CHECK_DIFFUSE)
                 for dev in ("cpu", device)}
        for vis in ("raycast", "tiled"):
            imgs = {str(dev): renderer.raster_step(*b[:7], 0, visibility=vis).cpu().numpy()
                    for dev, b in built.items()}
            frac, rel, ok = images_match(imgs[str(device)], imgs["cpu"], 0.995, 1e-3)
            log(f"[raster-blend] {kind} {RASTER_CHECK_RES[0]}x{RASTER_CHECK_RES[1]} {vis} card "
                f"vs CPU: {frac:.5f} of pixels within 1e-4 + 1e-3 relative, means {rel:.2e} "
                f"apart")
            if not ok or not np.isfinite(imgs[str(device)]).all():
                raise AssertionError(f"the {kind} raster frame ({vis}) on the card disagrees "
                                     f"with the CPU")

    # The 1080p frames.
    frames = {"materials": raster_frames("zoo", zoo, card, RASTER_TIMED_FRAMES)}
    t0 = time.perf_counter()
    court = build_raster_scene("courtyard", *FULL_RES, device=device)
    log(f"[raster-blend] courtyard raster build {time.perf_counter() - t0:.2f}s: "
        f"has_masked={court[1].has_masked} has_blend={court[1].has_blend}")
    frames["courtyard"] = raster_frames("courtyard", court, card, RASTER_TIMED_FRAMES)
    if not all(sum(f[2]) > 0 for f in frames["courtyard"].values()):
        raise AssertionError("the courtyard's raster frames ran no masked retry")

    # Motion vectors on the zoo at 1080p from a moved camera.
    w, h = FULL_RES
    w2v = camera.look_at(MOVED_ZOO_EYE, MATERIALS_VIEW[1])
    c2w = camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=w / h, z_near=0.01)
    lit, mv = rz.render(scene, meta, zoo[2], zoo[3], c2w, camera.position(w2v), (w, h), 0,
                        prev_world_to_clip=camera.world_to_clip(zoo[4]), with_motion=True)
    px, py, _ = pt._tile_order(w, h, scene.world.position.device)
    o, d, t_max = rz._pixel_rays(px, py, (w, h), torch.as_tensor(c2w, device=px.device))
    bg = pt._from_tile_order(pt.closest_hit(scene, meta, o, d, torch.zeros_like(t_max), t_max,
                                            blend_mode=bvh_ops.BLEND_EXCLUDE).tri < 0, w, h)
    moved = torch.sqrt((mv * mv).sum(-1))[~bg]
    log(f"[raster-blend] motion vectors {w}x{h}: background pixels {int(bg.sum())}, largest "
        f"background |mv| {float(torch.abs(mv[bg]).max()) if bool(bg.any()) else 0.0}, surface "
        f"|mv| mean {float(moved.mean()):.4f} max {float(moved.max()):.4f} pixels")
    if (tuple(mv.shape) != (h, w, 2) or not bool(torch.isfinite(mv).all())
            or not bool(torch.isfinite(lit).all()) or not bool(bg.any())
            or bool((mv[bg] != 0).any()) or not float(moved.max()) > 0.5):
        raise AssertionError("the zoo's motion vectors are wrong")
    return dict(k1=k1, frames=frames, ssim=box_ssim)


def images_match(got, want, share=0.98, mean_rel=0.01):
    """The CPU tests' bar for two renders: (share of pixels within atol 1e-4
    + rtol 1e-3, relative difference of the means, passes: at least `share`
    of pixels and means within `mean_rel`). The defaults are the path
    tracer's (tests/test_torch_pathtracer.py); raster frames are held to
    0.995 and 0.1% (tests/test_torch_raster_frame.py)."""
    close = np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)
    frac = float(close.all(-1).mean())
    rel = abs(float(got.mean()) - float(want.mean())) / max(abs(float(want.mean())), 1e-30)
    return frac, rel, frac >= share and rel <= mean_rel


def phase_courtyard(device, card):
    """The courtyard bench scene on the card (phase 7b). Returns the
    traversal kernel's courtyard numbers and the main-path run's counts."""
    from PIL import Image

    from gltf_renderer_tpu_torch.bench_scene import build_bench_scene, render_courtyard_golden
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    t0 = time.perf_counter()
    scene, meta, settings, params, c2w, n_tris = build_bench_scene(
        *FULL_RES, device=device, scene_kind="courtyard")
    log(f"[courtyard] {n_tris} triangles, stack bound {meta.stack_bound}, "
        f"{scene.wide_nodes.shape[0]} wide nodes, {scene.leaf_records.shape[0]} leaves, "
        f"has_masked={meta.has_masked}, built in {time.perf_counter() - t0:.2f}s")
    if not meta.has_masked or n_tris != 273856:
        raise AssertionError("the courtyard scene is not the bench's")

    # K1 against its plain version on the courtyard's tables, at the kernel
    # table's two launch sizes, timed through its wrapper; then at the path
    # tracer's own, untimed.
    sets = bench_traverse.ray_sets(scene, meta, params, c2w, bench_traverse.RAYS_RES, device)
    k1 = {rays[0]: k1_main_size(scene, meta, rays, "[courtyard] kernel")
          for rays in (sets[0], sets[2])}
    del sets
    chunk_rays = k1_chunk_size(scene, meta, params, c2w, device, "[courtyard] kernel")
    # Phase 5's tile-kernel check and timing on the courtyard's bench view.
    k2 = raster_view("courtyard", scene.world, c2w, timed=True)

    # The golden configuration, through the Renderer.
    img, stats = render_courtyard_golden(device)
    golden = np.asarray(Image.open(COURTYARD_GOLDEN))
    score = ssim(img, golden) if img.shape == golden.shape else 0.0
    log(f"[courtyard] golden {img.shape[1]}x{img.shape[0]} through Renderer.load_scene(path): "
        f"ssim={score:.6f} "
        f"(bar {RASTER_SSIM_BAR}) nan_inf={float(stats[1]):.0f}")
    if score < RASTER_SSIM_BAR or float(stats[1]) != 0.0:
        raise AssertionError("the courtyard golden fails its bar")

    phase_foliage(device)

    run = scene_steps("courtyard", scene, meta, settings, params, c2w, COURTYARD_TIMED_STEPS,
                      card)
    if sum(a for a, _ in run["hops"]) == 0:
        raise AssertionError("the courtyard step ran no masked retry")
    return dict(k1=k1, k2=k2, ssim=score, chunk_rays=chunk_rays, **run)


def scene_steps(tag, scene, meta, settings, params, c2w, timed, card):
    """The 1080p step, trace_chunked(spp=4), one warm and `timed` timed
    steps, with the launch counters reset first: every traversal launch is
    a chunk's primary or merged bounce launch, or one hop of a retry or
    alpha-shadow loop, and no plain version runs. Returns the launches,
    steps, hops a step, Mrays/s and the timed steps' seconds."""
    import torch

    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    w, h = FULL_RES
    tr.KERNEL_LAUNCHES = 0
    pt.ALPHA_RETRY_HOPS = pt.ALPHA_SHADOW_HOPS = 0
    ref_calls = tr.REFERENCE_CALLS
    rays = nan = 0.0
    step_s, hops = [], []
    img = None
    for i in range(timed + 1):
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
    chunks = stream_chunks(w, h, pt.RAY_CHUNK // SPP)
    steps = timed + 1
    expected = steps * chunks * (1 + settings.max_bounces) + sum(a + b for a, b in hops)
    mrays = rays / sum(step_s) / 1e6 if step_s else float("nan")
    log(f"[{tag}] main {w}x{h} spp={SPP} steps={[round(x, 4) for x in step_s]} "
        f"(after one warm) rays={rays:.0f} Mrays/s={mrays:.4f} nan_inf={nan:.0f} "
        f"traverse_launches={launches} in {steps} steps ({launches / steps:.1f} a step; "
        f"{chunks * (1 + settings.max_bounces)} a step without hops) "
        f"retry/shadow hops per step={hops} card={card}")
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()) or nan != 0.0:
        raise AssertionError(f"the {tag} step has the wrong shape or non-finite values")
    if launches != expected or tr.REFERENCE_CALLS != ref_calls:
        raise AssertionError(f"the {tag} step did not run through the traversal kernel "
                             f"only: {launches} launches, {expected} expected")
    return dict(launches=launches, steps=steps, hops=hops, mrays=mrays, step_s=step_s)


def phase_materials(device, card):
    """The material zoo on the card (phase 7c): sheen, clearcoat, thin
    transmission (BLEND-flagged for traversal), anisotropic metal. Returns
    the traversal kernel's zoo numbers and the main-path run's counts."""
    from PIL import Image

    from gltf_renderer_tpu_torch.bench_scene import (
        build_materials_scene,
        render_materials_golden,
    )
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    t0 = time.perf_counter()
    scene, meta, settings, params, c2w, n_tris = build_materials_scene(*FULL_RES, device=device)
    log(f"[materials] {n_tris} triangles, stack bound {meta.stack_bound}, "
        f"{scene.wide_nodes.shape[0]} wide nodes, {scene.leaf_records.shape[0]} leaves, "
        f"has_sheen={meta.has_sheen} has_clearcoat={meta.has_clearcoat} "
        f"has_transmission={meta.has_transmission} has_blend={meta.has_blend}, "
        f"built in {time.perf_counter() - t0:.2f}s")
    if not (meta.has_sheen and meta.has_clearcoat and meta.has_transmission
            and meta.has_blend) or n_tris != MATERIALS_TRIS:
        raise AssertionError("the materials scene is not the zoo")

    # K1 against its plain version on the zoo's tables, at the kernel
    # table's two launch sizes; timed through its wrapper.
    sets = bench_traverse.ray_sets(scene, meta, params, c2w, bench_traverse.RAYS_RES, device)
    k1 = {rays[0]: k1_main_size(scene, meta, rays, "[materials] kernel")
          for rays in (sets[0], sets[2])}

    # The golden configuration, through the Renderer.
    img, stats = render_materials_golden(device)
    golden = np.asarray(Image.open(MATERIALS_GOLDEN))
    score = ssim(img, golden) if img.shape == golden.shape else 0.0
    log(f"[materials] golden {img.shape[1]}x{img.shape[0]} through Renderer.load_scene(path): "
        f"ssim={score:.6f} "
        f"(bar {RASTER_SSIM_BAR}) nan_inf={float(stats[1]):.0f}")
    if score < RASTER_SSIM_BAR or float(stats[1]) != 0.0:
        raise AssertionError("the materials golden fails its bar")

    phase_materials_modes(device)
    run = scene_steps("materials", scene, meta, settings, params, c2w, MATERIALS_TIMED_STEPS,
                      card)
    return dict(k1=k1, ssim=score, **run)


def phase_materials_modes(device):
    """The zoo at 64x48 on the card against the same render on the CPU:
    the MIS, diffuse-white and non-MIS modes (2 bounces, seed 3), and the
    five debug outputs read after the first BSDF sample (1 bounce, seed 5)."""
    import dataclasses

    from gltf_renderer_tpu_torch.bench_scene import build_materials_scene
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import settings as S

    res = MATERIALS_CHECK_RES
    built = {dev: build_materials_scene(*res, device=dev) for dev in ("cpu", device)}
    runs = [(name, dict(kw), 3) for name, kw in (
        ("mis", {}), ("diffuse_white", dict(material_diffuse_white=True)),
        ("no_mis", dict(material_mis=False)))]
    runs += [(name, dict(max_bounces=1, min_bounces=1, debug_output=getattr(S, name)), 5)
             for name in ("DEBUG_BOUNCE_DIRECTION", "DEBUG_BOUNCE_BSDF", "DEBUG_BOUNCE_PDF",
                          "DEBUG_BOUNCE_WEIGHT", "DEBUG_BOUNCE_IS_TRANSMISSION")]
    for name, change, seed in runs:
        imgs = {}
        for dev, (scene, meta, settings, params, c2w, _) in built.items():
            img, st = pt.trace(scene, meta, dataclasses.replace(settings, **change), params, c2w,
                               res, seed, with_stats=True)
            imgs[str(dev)] = img.cpu().numpy()
            if not np.isfinite(imgs[str(dev)]).all() or float(st[1]) != 0.0:
                raise AssertionError(f"the zoo's {name} render on {dev} is not finite")
        frac, rel, ok = images_match(imgs[str(device)], imgs["cpu"])
        log(f"[materials] {res[0]}x{res[1]} {name} card vs CPU: {frac:.5f} of pixels within "
            f"atol 1e-4 + rtol 1e-3, means {rel:.2e} apart")
        if not ok:
            raise AssertionError(f"the zoo's {name} render on the card disagrees with the CPU")


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


def phase_env_io(device, tmp):
    """Phase 7e, environment IO: the bench's analytic sky at 2048x1024 as
    .hdr and as .exr ZIP float, a 256x128 crop as .exr PIZ half, each read
    back by read_environment_image (ZIP and PIZ bit-identical, RGBE within
    its 8-bit step) with the native PIZ decoder asserted, then
    build_environment (cube 128) on the card, fresh and from its cache.
    Returns the environment."""
    import torch

    from gltf_renderer_tpu_torch.bench_scene import analytic_sky
    from gltf_renderer_tpu_torch.env import hdr_io, piz
    from gltf_renderer_tpu_torch.env.environment import build_environment

    sky = analytic_sky(*SKY_HW)
    crop = np.ascontiguousarray(sky[:PIZ_CROP_HW[0], :PIZ_CROP_HW[1]])
    paths = {k: os.path.join(tmp, k) for k in ("sky.hdr", "sky.exr", "crop.exr")}
    secs = {}
    t0 = time.perf_counter()
    hdr_io.write_hdr(paths["sky.hdr"], sky)
    hdr_io.write_exr(paths["sky.exr"], sky, compression=3)
    secs["write_hdr_zip"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hdr_io.write_exr(paths["crop.exr"], crop, compression=4, half=True)
    secs["write_piz_crop"] = time.perf_counter() - t0
    got = {}
    for k, path in paths.items():
        decodes = piz.NATIVE_DECODES
        t0 = time.perf_counter()
        got[k] = hdr_io.read_environment_image(path)
        secs[f"read_{k}"] = time.perf_counter() - t0
        if k == "crop.exr" and piz.NATIVE_DECODES - decodes != -(-PIZ_CROP_HW[0] // 32):
            raise AssertionError(f"the PIZ crop's {-(-PIZ_CROP_HW[0] // 32)} blocks were not "
                                 f"decoded natively ({piz.NATIVE_DECODES - decodes} were)")
    hdr_err = float(np.abs(got["sky.hdr"] - sky).max() / sky.max())
    zip_ok = got["sky.exr"].tobytes() == sky.tobytes()
    piz_ok = got["crop.exr"].tobytes() == crop.astype(np.float16).astype(np.float32).tobytes()
    log(f"[env-io] {SKY_HW[1]}x{SKY_HW[0]} .hdr max error {hdr_err:.5f} of the maximum "
        f"(bar 2^-8 = {2.0 ** -8:.5f}); .exr ZIP float bit-identical={zip_ok}; "
        f"{PIZ_CROP_HW[1]}x{PIZ_CROP_HW[0]} .exr PIZ half bit-identical={piz_ok}, native "
        f"decoder {piz.native_piz()._name}; seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    if not (zip_ok and piz_ok and hdr_err <= 2.0 ** -8):
        raise AssertionError("an environment image did not read back as written")

    cache = os.path.join(tmp, "cache")
    t0 = time.perf_counter()
    env = build_environment(got["sky.exr"], ENV_CUBE, device, cache_dir=cache)
    torch.cuda.synchronize()
    secs["build_env"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hit = build_environment(got["sky.exr"], ENV_CUBE, device, cache_dir=cache)
    torch.cuda.synchronize()
    secs["build_env_cached"] = time.perf_counter() - t0
    same = True
    for f in env._fields:
        a, b = getattr(env, f), getattr(hit, f)
        a, b = (a, b) if isinstance(a, list) else ([a], [b])
        same = same and len(a) == len(b) and all(
            x.device == y.device and x.dtype == y.dtype and x.shape == y.shape
            and bool(torch.equal(x.view(-1).view(torch.int32), y.view(-1).view(torch.int32)))
            for x, y in zip(a, b))
    log(f"[env-io] build_environment cube {ENV_CUBE} on {env.cube[0].device}: "
        f"{secs['build_env']:.3f}s fresh, {secs['build_env_cached']:.3f}s from its cache, "
        f"bit-identical={same}, ggx levels {len(env.ggx)}, diffuse {tuple(env.diffuse.shape)}")
    if not same or env.cube[0].device.type != torch.device(device).type:
        raise AssertionError("the environment cache did not give the fresh build's tensors")
    return env


def phase_loaded_courtyard(device, card, env, tmp):
    """Phase 7e, the loader at full scale: the courtyard written as a GLB by
    the port's writer and read by the port's loader, every table
    bit-identical to the in-memory build, built through make_pt_scene and
    run for one 1080p step with exact launch and hop counts."""
    from gltf_renderer_tpu_torch.bench_scene import bench_camera, world_from_scene
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import settings as S
    from gltf_renderer_tpu_torch.scene.gltf import load_gltf
    from gltf_renderer_tpu_torch.scene.procedural import courtyard_scene, write_courtyard_glb

    secs = {}
    t0 = time.perf_counter()
    path = write_courtyard_glb(os.path.join(tmp, "courtyard.glb"), tex_size=256)
    secs["write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = load_gltf(path)
    secs["load"] = time.perf_counter() - t0
    ref = courtyard_scene(tex_size=256)
    differ = [f"{t}.{f}" for t in ("pools", "primitives", "materials", "textures",
                                   "light_params")
              for f in getattr(ref, t)._fields
              if not same_array(getattr(getattr(scene, t), f), getattr(getattr(ref, t), f))]
    differ += [f"nodes[{i}].{k}" for i, (a, b) in enumerate(zip(scene.nodes, ref.nodes))
               for k in vars(b) if not same_array(getattr(a, k), getattr(b, k))]
    differ += [f for f in ("light_nodes", "topo_order")
               if not same_array(getattr(scene, f), getattr(ref, f))]
    t0 = time.perf_counter()
    world, lights = world_from_scene(scene)
    ptscene, meta = pt.make_pt_scene(world, scene.materials, scene.textures, lights, env=env,
                                     device=device)
    secs["build"] = time.perf_counter() - t0
    n_tris = int(world.tri_vertex.shape[0])
    log(f"[loader] courtyard.glb {os.path.getsize(path)} bytes, {n_tris} triangles, atlas "
        f"{scene.textures.atlas.shape}: tables differing from the in-memory courtyard: "
        f"{differ or 'none'}; seconds write {secs['write']:.3f} load {secs['load']:.3f} "
        f"world + make_pt_scene {secs['build']:.3f}")
    if differ or n_tris != 273856 or len(scene.nodes) != len(ref.nodes):
        raise AssertionError("the loaded courtyard is not the in-memory courtyard")
    settings = S.PathTracerSettings(max_bounces=2, min_bounces=2, alpha_shadows=True)
    run = scene_steps("courtyard-glb", ptscene, meta, settings, S.PathTracerParams(),
                      bench_camera(*FULL_RES, "courtyard"), 0, card)
    return dict(run, secs=secs)


def same_array(a, b):
    """Same dtype, shape and bytes (NaN-bitcast words included), or equal
    non-arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


def refit_checks(anim):
    """The refitted node boxes of `anim`'s scene against a CPU refit of the
    same vertices (==, no NaN), and each box holding what it must: a leaf's
    triangles, an internal node's two children. Returns (equal, contained)."""
    import torch

    from gltf_renderer_tpu_torch.ops import bvh as bvh_ops

    s, tree = anim.ptscene, anim.bvh_host
    tv = s.world.tri_vertex.long()
    v = [s.world.position[tv[:, k]].cpu() for k in range(3)]
    cpu = bvh_ops.refit(tree, *v)
    lo, hi = s.bvh.aabb_min.cpu(), s.bvh.aabb_max.cpu()
    equal = (not bool(torch.isnan(lo).any() | torch.isnan(hi).any())
             and bool((lo == cpu.aabb_min).all() & (hi == cpu.aabb_max).all()))
    t_lo = torch.minimum(torch.minimum(v[0], v[1]), v[2])[torch.as_tensor(tree.tri_order).long()]
    t_hi = torch.maximum(torch.maximum(v[0], v[1]), v[2])[torch.as_tensor(tree.tri_order).long()]
    count, first, right = (np.asarray(x) for x in (tree.count, tree.first, tree.right))
    leaf = np.nonzero(count > 0)[0]
    slots = np.concatenate([np.arange(first[i], first[i] + count[i]) for i in leaf])
    owner = torch.as_tensor(np.repeat(leaf, count[leaf])).long()
    contained = bool((t_lo[slots] >= lo[owner]).all() & (t_hi[slots] <= hi[owner]).all())
    inner = np.nonzero(count == 0)[0]
    for child in (torch.as_tensor(inner + 1), torch.as_tensor(right[inner])):
        i = torch.as_tensor(inner)
        contained = contained and bool((lo[child] >= lo[i]).all() & (hi[child] <= hi[i]).all())
    return equal, contained


def phase_animation(device, card, env):
    """Phase 7e, animation at 1080p: the skinned strips and the morph cube,
    read by the loader, under the analytic environment; 8 frames of
    animate -> DynamicMeshState.update -> build_world_geometry ->
    refit_pt_scene -> trace_chunked(spp=4), each frame's refit and K1 on
    its tables checked; the last pose against a fresh build; one raster
    frame of the strips in each visibility; the anim_pose golden."""
    import torch
    from PIL import Image

    from gltf_renderer_tpu_torch import camera
    from gltf_renderer_tpu_torch.bench_scene import (
        ANIM_KINDS,
        ANIM_VIEWS,
        build_animated_scene,
        render_anim_pose_golden,
    )
    from gltf_renderer_tpu_torch.ops import raster
    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import rasterizer as rz
    from gltf_renderer_tpu_torch.render import renderer
    from gltf_renderer_tpu_torch.render import settings as S
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    w, h = FULL_RES
    out = {"k1": 0, "k2": 0, "worst_abs": 0.0}
    for kind in ANIM_KINDS:
        t0 = time.perf_counter()
        anim, settings, params, c2w = build_animated_scene(kind, w, h, device, strips=ANIM_STRIPS,
                                                           env=env)
        torch.cuda.synchronize()
        n_tris = int(anim.ptscene.world.tri_vertex.shape[0])
        log(f"[anim] {kind}: {n_tris} triangles, {len(anim.dynamic.dynamic_instances)} dynamic "
            f"primitives, {len(anim.scene.skins)} skins, built at t=0 in "
            f"{time.perf_counter() - t0:.3f}s")
        o, d, t_max = centre_chunk_rays(c2w, device)
        rays = ("anim_primary", o, d, torch.zeros_like(t_max), t_max, None)
        skin_ms, trace_ms = [], []
        chunks = stream_chunks(w, h, pt.RAY_CHUNK // SPP)
        for frame in range(ANIM_FRAMES):
            start, mid = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            anim.update(ANIM_DELTA)
            mid.record()
            ref_calls = tr.REFERENCE_CALLS
            launches0 = tr.KERNEL_LAUNCHES
            img, st = pt.trace_chunked(anim.ptscene, anim.meta, settings, params, c2w, (w, h),
                                       frame, with_stats=True, spp=SPP)
            end.record()
            torch.cuda.synchronize()
            launches = tr.KERNEL_LAUNCHES - launches0
            plain_ran = tr.REFERENCE_CALLS != ref_calls
            out["k1"] += launches
            skin_ms.append(start.elapsed_time(mid))
            trace_ms.append(mid.elapsed_time(end))
            frac, max_abs, _, same = compare(anim.ptscene, anim.meta, rays, 0, 0)
            out["worst_abs"] = max(out["worst_abs"], max_abs)
            equal, contained = refit_checks(anim)
            log(f"[anim] {kind} frame {frame} t={anim.player.time:.4f}: skin_and_refit "
                f"{skin_ms[-1]:.3f} ms, trace {trace_ms[-1]:.3f} ms; K1 launches {launches} "
                f"({chunks * (1 + settings.max_bounces)} expected); K1 vs plain on "
                f"{o.shape[0]} primary rays identical={same}; boxes == CPU refit {equal}, "
                f"contain their triangles and children {contained}; nan_inf={float(st[1]):.0f}")
            if (not (same and equal and contained) or launches != chunks
                    * (1 + settings.max_bounces) or plain_ran
                    or float(st[1]) != 0.0 or not bool(torch.isfinite(img).all())):
                raise AssertionError(f"the {kind} animation failed at frame {frame}")
        out[kind] = dict(skin_ms=skin_ms, trace_ms=trace_ms)
        log(f"[anim] {kind} {w}x{h} spp={SPP} per frame: skin_and_refit "
            f"{[round(x, 3) for x in skin_ms]} ms, trace {[round(x, 3) for x in trace_ms]} ms "
            f"(CUDA events) card={card}")

        # The last pose against a fresh build at the same pose, every pixel ray.
        fresh, *_ = build_animated_scene(kind, w, h, device, strips=ANIM_STRIPS, env=env,
                                         time=anim.player.time)
        px, py, _ = pt._tile_order(w, h, device)
        po, pd, plen = rz._pixel_rays(px, py, (w, h), torch.as_tensor(c2w, device=device))
        zero = torch.zeros_like(plen)
        a = pt.closest_hit(anim.ptscene, anim.meta, po, pd, zero, plen)
        b = pt.closest_hit(fresh.ptscene, fresh.meta, po, pd, zero, plen)
        t_same = identical(a.t, b.t)
        ties = int((a.tri != b.tri).sum())
        log(f"[anim] {kind} frame {ANIM_FRAMES} vs a fresh make_pt_scene at t="
            f"{anim.player.time:.4f}: closest t identical on all {po.shape[0]} rays={t_same}, "
            f"hits {int((a.tri >= 0).sum())}, ids differing on exact-t ties {ties}")
        if not t_same:
            raise AssertionError(f"the refit {kind} tables miss what a fresh build hits")

        if kind == "skinned":
            rs = S.RenderSettings(backend="rasterizer", width=w, height=h)
            cam_pos = camera.position(camera.look_at(*ANIM_VIEWS[kind]))
            raycast = stream_chunks(w, h, rz.RASTER_CHUNK)
            for vis, want in (("raycast", (raycast, 0)), ("tiled", (0, 1))):
                tr.KERNEL_LAUNCHES = raster.KERNEL_LAUNCHES = 0
                hdr = renderer.raster_step(anim.ptscene, anim.meta, rs, params, c2w, cam_pos,
                                           (w, h), 0, visibility=vis)
                img = renderer.post_step(hdr, rs.tonemap, rs.bloom, 0)
                torch.cuda.synchronize()
                got = (tr.KERNEL_LAUNCHES, raster.KERNEL_LAUNCHES)
                out["k1"] += got[0]
                out["k2"] += got[1]
                log(f"[anim] skinned raster frame {vis}: K1 {got[0]} K2 {got[1]} launches "
                    f"({want} expected), finite={bool(torch.isfinite(hdr).all())}")
                if got != want or not bool(torch.isfinite(hdr).all()) or img.dtype != torch.uint8:
                    raise AssertionError(f"the skinned raster frame ({vis}) is wrong")

    img, stats = render_anim_pose_golden(device)
    golden = np.asarray(Image.open(ANIM_GOLDEN))
    score = ssim(img, golden) if img.shape == golden.shape else 0.0
    log(f"[anim] anim_pose golden {img.shape[1]}x{img.shape[0]} through "
        f"Renderer.load_scene(path): ssim={score:.6f} "
        f"(bar {RASTER_SSIM_BAR}) nan_inf={float(stats[1]):.0f}")
    if score < RASTER_SSIM_BAR or float(stats[1]) != 0.0:
        raise AssertionError("the anim_pose golden fails its bar")
    out["ssim"] = score
    return out


def phase_app(device, card, env, tmp, court, blend):
    """Phase 7f, the Renderer, the CLI and the viewer on the card: the save
    / load round trip and the Renderer's 1080p frames on the courtyard GLB
    (phase 7e's file and environment); the CLI as subprocesses; the viewer
    over HTTP on the skinned strips. Returns the K1 launches this process
    made and the numbers logged."""
    from gltf_renderer_tpu_torch.ops import traverse as tr

    tr.KERNEL_LAUNCHES = 0
    ref_calls = tr.REFERENCE_CALLS
    path = os.path.join(tmp, "courtyard.glb")
    out = app_courtyard(device, card, env, path, tmp, court, blend)
    out["cli"] = app_cli(tmp, path)
    out["viewer"] = app_viewer(device, card, tmp)
    out["k1"] = tr.KERNEL_LAUNCHES
    if tr.REFERENCE_CALLS != ref_calls:
        raise AssertionError("phase 7f ran the traversal's plain version")
    return out


def app_renderer(device, env, path):
    """A Renderer on the courtyard GLB at 1920x1080 as the bench's
    courtyard (2 bounces, alpha shadows, the colonnade view) under `env`."""
    from gltf_renderer_tpu_torch.bench_scene import COURTYARD_VIEW, golden_renderer

    return golden_renderer(path, *FULL_RES, "pathtracer", COURTYARD_VIEW, device,
                           pt_kw=dict(max_bounces=2, min_bounces=2, alpha_shadows=True),
                           env=env)


def app_courtyard(device, card, env, path, tmp, court, blend):
    """The save / load round trip at 1080p (the third frame of a renderer
    and the first after load_state in a fresh one: u8 and HDR identical),
    then the Renderer's 1080p frames with profile on, path tracer (one warm
    and APP_TIMED_PT frames: every K1 launch accounted for) and raster (one
    warm and APP_TIMED_RASTER frames)."""
    import dataclasses

    from gltf_renderer_tpu_torch.ops import raster
    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import rasterizer as rz

    w, h = FULL_RES
    r1 = app_renderer(device, env, path)
    t0 = time.perf_counter()
    r1.draw_frame()
    first_s = time.perf_counter() - t0
    r1.draw_frame()
    ckpt = os.path.join(tmp, "state.npz")
    r1.save_state(ckpt)
    third = r1.draw_frame()
    r2 = app_renderer(device, env, path)
    r2.load_state(ckpt)
    resumed = r2.draw_frame()
    same_u8 = resumed.shape == third.shape and bool((resumed == third).all())
    same_hdr = identical(r2._accum, r1._accum)
    log(f"[app] save/load round trip, courtyard GLB {w}x{h} path tracer: frame 3 after "
        f"load_state identical u8={same_u8} HDR={same_hdr} (accumulated "
        f"{r2.accumulated_frames}, frame {r2.frame_index}); first frame with the build "
        f"{first_s:.3f}s")
    if not (same_u8 and same_hdr):
        raise AssertionError("the resumed frame differs from the third frame")

    # The Renderer's path-tracer frame: one warm, then timed, profile on.
    r1.profile = True
    chunks = stream_chunks(w, h, pt.RAY_CHUNK)
    r1.draw_frame()
    launches0, rays0 = tr.KERNEL_LAUNCHES, r1.ray_stats.clone()
    hops0 = pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS
    frame_ms, passes = [], []
    for _ in range(APP_TIMED_PT):
        img = r1.draw_frame()
        frame_ms.append(r1.stats["frame_ms"])
        passes.append(r1.stats["pass_ms"])
    launches = tr.KERNEL_LAUNCHES - launches0
    hops = pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS - hops0
    rays, nan = (float(x) for x in (r1.ray_stats - rays0))
    expected = APP_TIMED_PT * chunks * (1 + r1.settings.pt.max_bounces) + hops
    mrays = rays / (sum(frame_ms) / 1e3) / 1e6
    log(f"[app] Renderer path-tracer frame {w}x{h} spp=1 (courtyard GLB): frame_ms "
        f"{frame_ms} pass_ms {passes}; K1 launches {launches} in {APP_TIMED_PT} frames "
        f"({expected} expected: {chunks} chunks x 3 + {hops} retry / alpha-shadow hops); "
        f"rays {rays:.0f} -> {mrays:.4f} Mrays/s of the Renderer's frame against phase 7b's "
        f"spp=4 step {court['mrays']:.4f} (the difference: per-frame reset key, u8 copy to "
        f"the host, post and profile syncs); nan_inf={nan:.0f} card={card}")
    # The passes and the spans (render/renderer.py's docstring); the alpha
    # reads only where the scene has a masked material, or an alpha layer
    # that alpha shadows read.
    want = {"skin_and_refit", "path_trace_scene", "post(bloom+tonemap)", "u8_copy",
            "pt.chunk", "pt.k1", "pt.shade", "pt.nee"}
    meta = r1._meta
    if meta.has_masked or (r1.settings.pt.alpha_shadows and meta.has_alpha_layer):
        want.add("pt.alpha_read")
    if (launches != expected or nan != 0.0 or img.shape != (h, w, 3)
            or any(set(p) != want for p in passes)):
        raise AssertionError("the Renderer's 1080p path-tracer frames are wrong")

    # The raster backend through the same Renderer.
    r1.settings = dataclasses.replace(r1.settings, backend="rasterizer")
    r1.draw_frame()
    k1_0, k2_0, rh0 = tr.KERNEL_LAUNCHES, raster.KERNEL_LAUNCHES, rz.RASTER_RETRY_HOPS
    r_ms, r_passes = [], []
    for _ in range(APP_TIMED_RASTER):
        img = r1.draw_frame()
        r_ms.append(r1.stats["frame_ms"])
        r_passes.append(r1.stats["pass_ms"])
    k1 = tr.KERNEL_LAUNCHES - k1_0
    r_hops = rz.RASTER_RETRY_HOPS - rh0
    r_chunks = stream_chunks(w, h, rz.RASTER_CHUNK)
    d7 = blend["frames"]["courtyard"]["raycast"]
    log(f"[app] Renderer raster frame {w}x{h} raycast (courtyard GLB): frame_ms {r_ms} "
        f"pass_ms {r_passes}; K1 launches {k1} ({APP_TIMED_RASTER * r_chunks} + {r_hops} "
        f"retry hops expected), K2 {raster.KERNEL_LAUNCHES - k2_0}; phase 7d's courtyard "
        f"raycast frame: draw {[round(x * 1e3, 3) for x in d7[3]]} ms + post "
        f"{[round(x * 1e3, 3) for x in d7[4]]} ms card={card}")
    if (k1 != APP_TIMED_RASTER * r_chunks + r_hops or raster.KERNEL_LAUNCHES != k2_0
            or img.shape != (h, w, 3) or float(img.std()) == 0.0):
        raise AssertionError("the Renderer's 1080p raster frames are wrong")
    return dict(frame_ms=frame_ms, pass_ms=passes, mrays=mrays, pt_launches=launches,
                pt_hops=hops, raster_ms=r_ms, raster_pass_ms=r_passes)


def app_cli(tmp, courtyard):
    """`python -m gltf_renderer_tpu_torch.app.cli` as a user runs it, the
    four runs started together (each its own process on the one card).
    Returns each run's wall seconds."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from gltf_renderer_tpu_torch.scene.procedural import write_skinned_gltf

    strips = write_skinned_gltf(os.path.join(tmp, "strips.gltf"), strips=ANIM_STRIPS)
    w, h = FULL_RES
    size = ["--width", str(w), "--height", str(h)]
    sky = ["--environment-map", os.path.join(tmp, "sky.hdr")]
    runs = {
        "pathtracer": (["--gltf", courtyard, *size, "--spp", "4", *sky], ["cli_pt.png"], 0),
        "rasterizer": (["--gltf", courtyard, *size, "--backend", "rasterizer", *sky],
                       ["cli_raster.png"], 0),
        "frames": (["--gltf", strips, "--width", "960", "--height", "540", "--spp", "1",
                    "--frames", "3", "--animation", "0"],
                   [f"cli_frames_{k:04d}.png" for k in range(3)], 0),
        "missing": (["--gltf", os.path.join(tmp, "missing.glb")], [], 1),
    }

    def run(name):
        argv, files, _ = runs[name]
        out = os.path.join(tmp, "cli_frames.png" if name == "frames" else
                           files[0] if files else "cli_missing.png")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "gltf_renderer_tpu_torch.app.cli", *argv,
                               "--output", out], cwd=ROOT, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        return proc, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(runs)) as pool:
        done = dict(zip(runs, pool.map(run, runs)))
    log(f"[app] cli: {len(runs)} runs at once in {time.perf_counter() - t0:.2f}s wall")
    walls = {}
    for name, (argv, files, rc_want) in runs.items():
        proc, walls[name] = done[name]
        imgs = [np.asarray(Image.open(os.path.join(tmp, f))) for f in files
                if os.path.exists(os.path.join(tmp, f))]
        shape = (540, 960, 3) if name == "frames" else (h, w, 3)
        ok = (proc.returncode == rc_want and len(imgs) == len(files)
              and all(i.shape == shape and i.dtype == np.uint8 and i.std() > 0 for i in imgs))
        if name == "frames":
            ok = ok and all((imgs[k] != imgs[k + 1]).any() for k in range(2))
        log(f"[app] cli {name}: rc {proc.returncode} (want {rc_want}), {walls[name]:.2f}s wall, "
            f"files {files} shapes {[i.shape for i in imgs]} std "
            f"{[round(float(i.std()), 2) for i in imgs]}; last stderr line: "
            f"{(proc.stderr.strip().splitlines() or [''])[-1]}")
        if not ok:
            for line in proc.stderr.splitlines()[-20:]:
                log(f"[app:cli:stderr] {line}")
            raise AssertionError(f"the CLI run {name} failed its checks")
        if proc.stdout.strip():
            raise AssertionError(f"the CLI printed on stdout: {proc.stdout[:200]!r}")
    return walls


def app_viewer(device, card, tmp):
    """The viewer on the skinned strips at 960x540, on a loopback port:
    one orbit, one `set` of debug_output, one backend toggle and one
    animation transport input, each seen in /state and followed by a newer
    /frame.png; then shut down. Returns the wall seconds of each wait."""
    import urllib.request

    from gltf_renderer_tpu_torch.app import viewer

    def get(path):
        return urllib.request.urlopen(base + path, timeout=10)

    def state():
        return json.loads(get("/state").read())

    def wait(pred, what):
        deadline = time.perf_counter() + VIEWER_DEADLINE_S
        while time.perf_counter() < deadline:
            st = state()
            if st["error"]:
                raise AssertionError(f"the viewer's render loop failed: {st['error']}")
            if pred(st):
                return st
            time.sleep(0.02)
        raise AssertionError(f"the viewer timed out waiting for {what}")

    def seq():
        return int(get("/frame.png").headers["X-Frame-Seq"])

    t0 = time.perf_counter()
    server, vstate, thread = viewer.serve(os.path.join(tmp, "strips.gltf"), width=960,
                                          height=540, port=0, block=False, device=device,
                                          host="127.0.0.1")
    walls = {}
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        wait(lambda st: st["frame"] > 0, "the first frame")
        walls["first_frame"] = time.perf_counter() - t0
        inputs = {
            "orbit": ({"type": "orbit", "dx": 60, "dy": 10}, lambda st: st["orbit"][0] != 0.0),
            "set": ({"type": "set", "field": "debug_output", "value": 11},
                    lambda st: st["settings"]["debug_output"] == 11),
            "backend": ({"type": "backend"}, lambda st: st["backend"] == "rasterizer"),
            "anim": ({"type": "anim", "playing": False, "time": 0.25},
                     lambda st: not st["animation_playing"] and st["animation_time"] == 0.25),
        }
        for name, (ev, shown) in inputs.items():
            t1 = time.perf_counter()
            req = urllib.request.Request(base + "/input", data=json.dumps(ev).encode(),
                                         method="POST")
            if urllib.request.urlopen(req, timeout=10).read() != b"ok":
                raise AssertionError(f"the viewer refused {ev}")
            seen = wait(shown, f"{name} in /state")["frame"]
            wait(lambda st: st["frame"] > seen, f"a frame after {name}")
            if seq() <= seen:
                raise AssertionError(f"/frame.png did not advance after {name}")
            walls[name] = time.perf_counter() - t1
        st = state()
        log(f"[app] viewer 960x540 strips: first frame {walls['first_frame']:.2f}s; input -> "
            f"/state -> newer frame: " + ", ".join(f"{k} {v:.3f}s" for k, v in walls.items()
                                                   if k != "first_frame")
            + f"; frames {st['frame']}, last frame_ms {st['stats'].get('frame_ms')} "
              f"card={card}")
    finally:
        vstate.running = False
        server.shutdown()
        server.server_close()
        thread.join(timeout=VIEWER_DEADLINE_S)
    if thread.is_alive() or vstate.error:
        raise AssertionError(f"the viewer's render loop did not stop cleanly: {vstate.error}")
    return walls


def shard_renderer(path, kind, device, env, mesh=None):
    """A 1080p Renderer for phase 7g: the courtyard path traced as 7f's
    (2 bounces, alpha shadows, the colonnade view) or the zoo rasterized
    (raycast; its transmissive sphere puts the backdrop gather on the
    path), under `env`."""
    from gltf_renderer_tpu_torch.bench_scene import (COURTYARD_VIEW, MATERIALS_VIEW,
                                                     golden_renderer)

    if kind == "pathtracer":
        return golden_renderer(path, *FULL_RES, "pathtracer", COURTYARD_VIEW, device,
                               pt_kw=dict(max_bounces=2, min_bounces=2, alpha_shadows=True),
                               env=env, mesh=mesh)
    return golden_renderer(path, *FULL_RES, "rasterizer", MATERIALS_VIEW, device, env=env,
                           mesh=mesh)


def shard_frames(renderer, frames=SHARD_FRAMES):
    """`frames` frames of `renderer`, each counted: u8 and HDR frames (on
    the host), K1 launches, alpha hops, wall ms, collective ms and the
    gathers (name, bytes) of each frame."""
    import torch

    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import rasterizer as rz

    out = dict(u8=[], hdr=[], k1=[], hops=[], wall_ms=[], collective_ms=[], gathers=[])
    for _ in range(frames):
        k1 = tr.KERNEL_LAUNCHES
        hops = pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS + rz.RASTER_RETRY_HOPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["u8"].append(renderer.draw_frame())
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["hdr"].append(renderer._accum.cpu().numpy())
        out["k1"].append(tr.KERNEL_LAUNCHES - k1)
        out["hops"].append(pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS + rz.RASTER_RETRY_HOPS
                           - hops)
        out["collective_ms"].append(renderer.stats.get("collective_ms"))
        if renderer.mesh is not None:
            out["gathers"].append([(name, b) for name, b, _ in renderer.mesh.log])
    return out


def expected_k1(kind, mesh, hops):
    """K1 launches of one 1080p frame on this rank: the path tracer 3 a
    chunk of each cell (2 bounces), the raster frame one a chunk of its
    region and MAX_BLEND_LAYERS more in the blend pass; one a hop."""
    from gltf_renderer_tpu_torch.parallel import sharding
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import rasterizer as rz

    w, h = FULL_RES
    tile_h = -(-h // mesh.n_tile)
    if kind == "pathtracer":
        return 3 * stream_chunks(w, tile_h, pt.RAY_CHUNK) * len(mesh.cells()) + hops
    rows = sharding._regions(mesh)[mesh.rank][1] * tile_h
    return (1 + rz.MAX_BLEND_LAYERS) * stream_chunks(w, rows, rz.RASTER_CHUNK) + hops


def same_frames(a, b):
    """Every u8 and HDR frame of two shard_frames runs identical."""
    return (len(a["u8"]) == len(b["u8"])
            and all(x.shape == y.shape and (x == y).all() for x, y in zip(a["u8"], b["u8"]))
            and all(x.tobytes() == y.tobytes() for x, y in zip(a["hdr"], b["hdr"])))


def closing_exchange_turns(renderer):
    """What the closing status exchange of a sharded Renderer frame costs:
    frames without it (Renderer._frame, the frame as drawn before the
    exchange was added) and with it (draw_frame), host ms each from a
    device sync to the u8 copy, in turns (without, with, with, without);
    and the mean ms of 20 lone exchanges. Every rank of the group calls it."""
    import torch

    from gltf_renderer_tpu_torch.parallel.distributed import exchange

    out = {"without": [], "with": []}
    for name in ("without", "with", "with", "without"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "with":
            renderer.draw_frame()
        else:
            renderer._frame(0.0, None)
        out[name].append(round((time.perf_counter() - t0) * 1e3, 3))
    t0 = time.perf_counter()
    for _ in range(20):
        exchange(None)
    out["exchange_ms"] = round((time.perf_counter() - t0) * 1e3 / 20, 4)
    return out


def phase_sharded(device, card, env, tmp, helmet_world):
    """Phase 7g, multi-device rendering and the rest of queue A on the
    card. Returns the K1 and K2 launches of its main-path runs."""
    import torch

    from gltf_renderer_tpu_torch.scene.procedural import write_materials_gltf

    paths = {"pathtracer": os.path.join(tmp, "courtyard.glb"),
             "rasterizer": write_materials_gltf(os.path.join(tmp, "zoo.gltf"))}
    t0 = time.perf_counter()
    one = shard_one_process(device, card, env, paths)
    log(f"[done] phase 7g (a) in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = shard_two_ranks(device, card, tmp, paths, one)
    log(f"[done] phase 7g (b) in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    nccl_k1 = shard_nccl(device, card, env, paths, one)
    log(f"[done] phase 7g (c) in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    k2 = phase_host_raster(device, card, helmet_world, paths["pathtracer"])
    log(f"[done] phase 7g (d) in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    hop_k1 = phase_hop_bounds(device, card, tmp)
    log(f"[done] phase 7g (e) in {time.perf_counter() - t0:.1f}s")
    return dict(k1=one["k1"] + ranks + nccl_k1 + hop_k1, k2=k2)


def shard_one_process(device, card, env, paths):
    """7g (a): one process, no process group. Each kind's frames unsharded
    and through Renderer(mesh=make_mesh(1, 4)), identical in u8 and HDR;
    the path tracer's first frame through a 2 x 2 mesh against the mean of
    its two seeds' unsharded samples."""
    import torch

    from gltf_renderer_tpu_torch.parallel import sharding
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    out, k1 = {}, 0
    for kind, path in paths.items():
        single = shard_frames(shard_renderer(path, kind, device, env))
        mesh = sharding.make_mesh(*SHARD_MESH, device=device)
        sharded = shard_frames(shard_renderer(path, kind, device, env, mesh))
        want = [expected_k1(kind, mesh, h) for h in sharded["hops"]]
        same = same_frames(single, sharded)
        log(f"[shard] (a) {kind} {FULL_RES[0]}x{FULL_RES[1]} {SHARD_MESH[0]}x{SHARD_MESH[1]} mesh, one process, "
            f"{SHARD_FRAMES} frames: identical to unsharded (u8, HDR)={same}; K1 launches "
            f"{sharded['k1']} (expected {want}: {len(mesh.cells())} cells, hops "
            f"{sharded['hops']}), unsharded {single['k1']}; wall ms {[round(x, 3) for x in sharded['wall_ms']]} "
            f"unsharded {[round(x, 3) for x in single['wall_ms']]} card={card}")
        if not same or sharded["k1"] != want:
            raise AssertionError(f"the one-process sharded {kind} frames are wrong")
        out[kind] = sharded
        k1 += sum(sharded["k1"])

    # The 2 x 2 mesh: the frame is the mean of seeds 0 and 0 + SEED_STRIDE.
    mesh = sharding.make_mesh(2, 2, device=device)
    r = shard_renderer(paths["pathtracer"], "pathtracer", device, env, mesh)
    got = shard_frames(r, frames=1)
    k1 += got["k1"][0]
    halves = [pt.trace(r._ptscene, r._meta, r.settings.pt, r.params, r.camera.clip_to_world(),
                       FULL_RES, (s * pt.SEED_STRIDE) & 0xFFFFFFFF) for s in range(2)]
    want = ((halves[0] + halves[1]) / 2).cpu().numpy()
    diff = float(np.abs(got["hdr"][0] - want).max())
    log(f"[shard] (a) pathtracer 2x2 mesh, first frame vs the mean of the two seeds' unsharded "
        f"samples: identical={got['hdr'][0].tobytes() == want.tobytes()}, largest difference "
        f"{diff}; K1 launches {got['k1'][0]} (expected "
        f"{expected_k1('pathtracer', mesh, got['hops'][0])}) card={card}")
    if diff > 1e-5 or got["k1"][0] != expected_k1("pathtracer", mesh, got["hops"][0]):
        raise AssertionError("the 2x2 mesh's frame is not the mean of its two samples")
    return dict(out, k1=k1)


def shard_rank(rank, world, store, tmp, paths, result, device):
    """7g (b): one rank of a gloo group on `device` (cuda:0 for both). Loads
    the scenes and the environment itself and draws each kind's frames
    through Renderer(mesh="auto"); writes shard_frames' results to
    `result`."""
    import pickle

    import torch

    from gltf_renderer_tpu_torch.env.environment import build_environment
    from gltf_renderer_tpu_torch.env.hdr_io import read_environment_image
    from gltf_renderer_tpu_torch.parallel import distributed

    distributed.initialize(backend="gloo", init_method=f"file://{store}", world_size=world,
                           rank=rank, device=device)
    try:
        env = build_environment(read_environment_image(os.path.join(tmp, "sky.exr")), ENV_CUBE,
                                device, cache_dir=os.path.join(tmp, "cache"))
        out = {}
        for kind, path in paths.items():
            r = shard_renderer(path, kind, device, env, mesh="auto")
            res = shard_frames(r)
            if kind == "pathtracer":
                res["turns"] = closing_exchange_turns(r)
            out[kind] = dict(res, cells=r.mesh.cells(), rank=r.mesh.rank,
                             world=r.mesh.world_size, backend=torch.distributed.get_backend(),
                             expected=[expected_k1(kind, r.mesh, h) for h in res["hops"]])
    finally:
        torch.distributed.destroy_process_group()
    with open(result, "wb") as f:
        pickle.dump(out, f)


def shard_two_ranks(device, card, tmp, paths, one):
    """7g (b): two spawned ranks on the one card (gloo), each against 7g
    (a)'s frames; both joined within SHARD_RANK_DEADLINE_S or killed and
    failed. Returns the ranks' K1 launches."""
    import multiprocessing
    import pickle

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(tmp, "shard_store")
    results = [os.path.join(tmp, f"shard_rank{r}.pkl") for r in range(2)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=shard_rank, args=(r, 2, store, tmp, paths, results[r],
                                                  str(device))) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARD_RANK_DEADLINE_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=30)
    if hung or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"7g (b): ranks {hung} hung past {SHARD_RANK_DEADLINE_S}s or a rank "
                             f"failed (exit codes {[p.exitcode for p in procs]})")
    log(f"[shard] (b) two gloo ranks on {device} done in {time.perf_counter() - t0:.2f}s wall "
        f"(start, import, scene builds and frames)")
    k1 = 0
    for r, path in enumerate(results):
        with open(path, "rb") as f:
            got = pickle.load(f)
        for kind, res in got.items():
            same = same_frames(res, one[kind])
            per = "3 a chunk + alpha hops" if kind == "pathtracer" else "5 a chunk + retry hops"
            log(f"[shard] (b) rank {res['rank']}/{res['world']} ({res['backend']}, {device}) {kind} "
                f"cells {res['cells']}: identical to (a) (u8, HDR)={same}; K1 launches "
                f"{res['k1']} (expected {res['expected']}: {per} {res['hops']}); wall ms "
                f"{[round(x, 3) for x in res['wall_ms']]}; collective ms {res['collective_ms']} "
                f"(gathers {res['gathers'][-1]}) card={card}")
            if not same or res["k1"] != res["expected"] or res["backend"] != "gloo":
                raise AssertionError(f"rank {r}'s {kind} frames are wrong")
            if "turns" in res:
                log(f"[shard] (b) rank {res['rank']} closing exchange: {kind} frame ms without "
                    f"it {res['turns']['without']}, with it {res['turns']['with']} (in turns: "
                    f"without, with, with, without); a lone exchange "
                    f"{res['turns']['exchange_ms']} ms (mean of 20) card={card}")
            k1 += sum(res["k1"])
    return k1


def shard_nccl(device, card, env, paths, one):
    """7g (c): an nccl group of world 1 in this process, the sharded
    path-tracer frames of (a) through Renderer(mesh=make_mesh(1, 4)),
    identical to (a)'s (the first gather also sets NCCL up); the group is
    destroyed after. Returns its K1 launches."""
    import socket

    import torch

    from gltf_renderer_tpu_torch.parallel import distributed, sharding

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(backend="nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                           rank=0, device=device)
    try:
        backend = torch.distributed.get_backend()
        mesh = sharding.make_mesh(*SHARD_MESH, device=device)
        renderer = shard_renderer(paths["pathtracer"], "pathtracer", device, env, mesh)
        got = shard_frames(renderer)
        turns = closing_exchange_turns(renderer)
    finally:
        torch.distributed.destroy_process_group()
    same = same_frames(got, one["pathtracer"])
    log(f"[shard] (c) {backend} group of world 1, {SHARD_MESH[0]}x{SHARD_MESH[1]} mesh, "
        f"pathtracer, {SHARD_FRAMES} frames: identical to (a) (u8, HDR)={same}; gathers "
        f"{got['gathers'][-1]}, collective ms {got['collective_ms']}; K1 launches {got['k1']}; "
        f"wall ms {[round(x, 3) for x in got['wall_ms']]} card={card}")
    log(f"[shard] (c) closing exchange: pathtracer frame ms without it {turns['without']}, "
        f"with it {turns['with']} (in turns: without, with, with, without); a lone exchange "
        f"{turns['exchange_ms']} ms (mean of 20) card={card}")
    if not same or backend != "nccl" or not all(got["gathers"]):
        raise AssertionError("the nccl-group frame differs from the one-process frame")
    return sum(got["k1"])


def phase_host_raster(device, card, helmet_world, court_path):
    """7g (d): the host-binned rasterize at 1080p on the helmet's and the
    courtyard's bench views (cull +1): its one K2 launch a call; K2 on the
    host-built lists bit-identical to its plain version; the pixels whose
    triangle differs from rasterize_device's, all of them on near-clipped
    triangles; the host stages' and K2's ms. Returns the K2 launches of
    the two rasterize calls."""
    import torch

    from gltf_renderer_tpu_torch import camera
    from gltf_renderer_tpu_torch.bench_scene import bench_camera, world_from_scene
    from gltf_renderer_tpu_torch.ops import raster
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.scene.gltf import load_gltf

    court_world = pt._to_device(world_from_scene(load_gltf(court_path))[0], device)
    w, h = FULL_RES
    launches = 0
    for name, world in (("helmet", helmet_world), ("courtyard", court_world)):
        args = (world.position, world.tri_vertex, camera.world_to_clip(bench_camera(w, h, name)),
                w, h)
        ds = world.tri_double_sided
        raster.KERNEL_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, tri, u, v = raster.rasterize(*args, double_sided=ds)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        k2 = raster.KERNEL_LAUNCHES
        launches += k2

        ms = {}
        t0 = time.perf_counter()
        setup = raster.build_setup(*args, double_sided=ds)
        ms["build_setup"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        flat, offsets, tiles = raster.bin_triangles(setup, w, h)
        ms["bin_triangles"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        lists = (torch.as_tensor(flat, device=device), torch.as_tensor(offsets, device=device))
        torch.cuda.synchronize()
        ms["lists_to_card"] = (time.perf_counter() - t0) * 1e3
        kargs = (setup.rows, setup.rows_i, *lists, tiles)
        got = raster.rasterize_tiles(*kargs, cull_sign=1)
        want = raster.rasterize_tiles_ref(*kargs, cull_sign=1)
        same = {n: identical(a, b) for n, a, b in zip(("z", "tri", "u", "v"), got, want)}
        crop = identical(got[1][:h, :w], tri)
        k2_ms = cuda_ms(lambda: raster.rasterize_tiles(*kargs, cull_sign=1), 10)

        dev = raster.rasterize_device(*args, double_sided=ds)
        n = world.tri_vertex.shape[0]
        crossers = torch.unique(setup.rows_i[n:, 0])
        differ = dev[1] != tri
        near = torch.isin(tri, crossers) | torch.isin(dev[1], crossers)
        n_diff, away = int(differ.sum()), int((differ & ~near).sum())
        log(f"[host-raster] {name} {w}x{h}: rasterize {call_ms:.3f} ms wall, K2 launches {k2}; "
            f"host stages " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
            + f"; K2 on the host lists {k2_ms:.4f} ms (CUDA events, 10 calls); rows "
              f"{setup.rows.shape[0]} ({setup.rows.shape[0] - n} clipped pieces of "
              f"{len(crossers)} crossers), pairs {len(flat)}; K2 vs plain identical={same}, "
              f"rasterize's crop identical={crop}; vs rasterize_device: {n_diff} pixels "
              f"differ, {away} away from near-clipped triangles; covered "
              f"{int((tri >= 0).sum())} card={card}")
        if k2 != 1 or not all(same.values()) or not crop or away or not (tri >= 0).any():
            raise AssertionError(f"the host-binned rasterize is wrong on the {name} view")
    return launches


def phase_hop_bounds(device, card, tmp):
    """7g (e): the hop-bound scene (tests/test_torch_hop_bounds.py) on the
    card: trace_closest, the raster retry and trace_shadow(alpha_shadow)
    through K1 against the same calls on the CPU (the plain version), and
    the bounded results the CPU test pins for every N. Returns the card's
    K1 launches."""
    import torch

    from gltf_renderer_tpu_torch.bench_scene import world_from_scene
    from gltf_renderer_tpu_torch.ops import bvh as bvh_ops
    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import rasterizer as rz
    from gltf_renderer_tpu_torch.scene.gltf import load_gltf
    from gltf_renderer_tpu_torch.scene.procedural import (ALPHA_STACK_LAYERS, alpha_stack_rays,
                                                          write_alpha_stack_gltf)

    srcs = {m: load_gltf(write_alpha_stack_gltf(os.path.join(tmp, f"stack_{m}.gltf"), m, 0.25))
            for m in ("MASK", "BLEND")}
    origin, direction, stack = alpha_stack_rays()
    res, k1 = {}, 0
    for dev in ("cpu", device):
        sc = {}
        for m, src in srcs.items():
            world, lights = world_from_scene(src)
            sc[m] = pt.make_pt_scene(world, src.materials, src.textures, lights, device=dev)
        o, d = (torch.as_tensor(x, device=dev) for x in (origin, direction))
        t_min = torch.zeros(len(origin), device=dev)
        t_max = torch.full((len(origin),), 100.0, device=dev)
        launches = tr.KERNEL_LAUNCHES
        first = pt.closest_hit(*sc["MASK"], o, d, t_min, t_max, blend_mode=bvh_ops.BLEND_EXCLUDE)
        res[str(dev)] = dict(
            closest=pt.trace_closest(*sc["MASK"], o, d, t_min, t_max),
            raster=rz._alpha_retry_raster(*sc["MASK"], first, o, d, t_max),
            shadow=pt.trace_shadow(*sc["BLEND"], o, d, t_max, alpha_shadow=True))
        if dev != "cpu":
            k1 = tr.KERNEL_LAUNCHES - launches
    cpu, card_res = res["cpu"], res[str(device)]
    bounded = np.float32(1.0)
    for _ in range(pt.MAX_SHADOW_HOPS):
        bounded = bounded * (np.float32(1.0) - np.float32(0.25))
    rows, ok = [], k1 == 2 + 2 * pt.MAX_ALPHA_HOPS + pt.MAX_SHADOW_HOPS
    for path in ("closest", "raster"):
        a, b = card_res[path], cpu[path]
        bits = all(identical(x.cpu(), y) for x, y in zip(a, b))
        ok &= bool(torch.equal(a.tri.cpu(), b.tri)) and bool(torch.allclose(a.t.cpu(), b.t,
                                                                            rtol=1e-6, atol=0))
        rows.append(f"{path} identical to the CPU's (t, tri, u, v bits)={bits}")
    shadow = card_res["shadow"].cpu().numpy()
    ok &= shadow.tobytes() == cpu["shadow"].numpy().tobytes()
    per_n = []
    for k, n in enumerate(ALPHA_STACK_LAYERS):
        lanes = stack == k
        t = card_res["closest"].t.cpu().numpy()[lanes]
        want_t = 30.0 if n <= pt.MAX_ALPHA_HOPS else 9.0
        want_s = 0.0 if n + 1 <= pt.MAX_SHADOW_HOPS else bounded
        ok &= bool(np.allclose(t, want_t, rtol=1e-6)) and bool((shadow[lanes] == want_s).all())
        per_n.append(f"N={n}: hit x={float(t[0]):.4f} transmission {float(shadow[lanes][0]):.6g}")
    log(f"[hops] alpha stacks on the card, {len(origin)} rays: " + "; ".join(rows)
        + f"; shadow identical={shadow.tobytes() == cpu['shadow'].numpy().tobytes()}; "
          + ", ".join(per_n) + f"; K1 launches {k1} (expected {2 + 2 * pt.MAX_ALPHA_HOPS + pt.MAX_SHADOW_HOPS}: a "
          f"first hit and {pt.MAX_ALPHA_HOPS} hops for each retry, {pt.MAX_SHADOW_HOPS} shadow "
          f"hops) card={card}")
    if not ok:
        raise AssertionError("the hop-bound scene differs on the card")
    return k1


def phase_config5(device, card, tmp):
    """Phase 7h, BASELINE config 5's tool at 1920x1080: two subprocess
    sessions (CONFIG5_SESSIONS, the second resuming from the first's
    checkpoint) against one uninterrupted session of the tool's main in
    this process, the launch counters reset just before it. Returns the
    K1 launches of that session and the numbers logged."""
    import subprocess

    from PIL import Image

    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.ops import warm
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.tools import render_config5 as tool

    w, h = FULL_RES
    chunks = stream_chunks(w, h, pt.RAY_CHUNK)
    per_frame = chunks * (1 + 2)  # 2 bounces: primary, bounce and shadow launches a chunk

    def files(out):
        with np.load(os.path.join(out, tool.CKPT)) as ck:
            state = (ck["accum"], int(ck["accumulated_frames"]), int(ck["frame_index"]))
        with open(os.path.join(out, tool.PROGRESS)) as f:
            progress = json.load(f)
        return state, np.asarray(Image.open(os.path.join(out, tool.PNG))), progress

    def counted(prog):
        return prog["k1_launches_this_session"] == (per_frame * prog["frames_this_session"]
                                                    + prog["alpha_hops_this_session"])

    size = ["--width", str(w), "--height", str(h), "--ckpt-every", str(CONFIG5_CKPT_EVERY)]
    cut = os.path.join(tmp, "config5_cut")
    for frames in CONFIG5_SESSIONS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "gltf_renderer_tpu_torch.tools.render_config5",
                               "--frames", str(frames), *size, "--out", cut], cwd=ROOT,
                              capture_output=True, text=True, timeout=CONFIG5_TIMEOUT_S)
        wall = time.perf_counter() - t0
        prog = files(cut)[2] if proc.returncode == 0 else {}
        log(f"[config5] session to {frames} spp: rc {proc.returncode}, {wall:.2f}s wall; "
            f"progress {prog}; stdout {proc.stdout.strip().splitlines()}")
        if proc.returncode != 0 or prog.get("spp") != frames or not counted(prog):
            for line in proc.stderr.splitlines()[-20:]:
                log(f"[config5:stderr] {line}")
            raise AssertionError(f"the config 5 session to {frames} spp failed its checks")

    whole = os.path.join(tmp, "config5_whole")
    ref_calls = tr.REFERENCE_CALLS
    tr.KERNEL_LAUNCHES = 0
    warm.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    rc = tool.main(["--frames", str(CONFIG5_SESSIONS[-1]), *size, "--out", whole],
                   device=str(device))
    wall = time.perf_counter() - t0
    k1, k6 = tr.KERNEL_LAUNCHES, warm.KERNEL_LAUNCHES
    (acc_a, spp_a, fi_a), img_a, prog = files(whole)
    (acc_b, spp_b, fi_b), img_b, prog_b = files(cut)
    same_accum = acc_a.shape == (h, w, 3) and acc_a.tobytes() == acc_b.tobytes()
    same_u8 = img_a.shape == img_b.shape == (h, w, 3) and bool((img_a == img_b).all())
    frames = prog["frames_this_session"]
    nonfinite = int((~np.isfinite(acc_a)).sum())
    log(f"[config5] uninterrupted session in this process ({wall:.2f}s wall with the build): "
        f"rc {rc}; against the two sessions: accumulation bits identical={same_accum}, u8 "
        f"identical={same_u8}, (spp, frame index) {(spp_a, fi_a)} / {(spp_b, fi_b)}; "
        f"{prog['s_per_sample_this_session']:.4f} s a sample (resumed session "
        f"{prog_b['s_per_sample_this_session']:.4f}); K1 launches {k1} in {frames} frames "
        f"({k1 / frames:.2f} a frame: {per_frame} + {prog['alpha_hops_this_session'] / frames:.2f}"
        f" alpha hops), K6 {k6}; non-finite accumulated values {nonfinite}; u8 mean "
        f"{float(img_a.mean()):.3f} std {float(img_a.std()):.3f} card={card}")
    if not (rc == 0 and same_accum and same_u8 and spp_a == spp_b == CONFIG5_SESSIONS[-1]
            and fi_a == fi_b and k1 == prog["k1_launches_this_session"] and counted(prog)
            and k6 == 1 and tr.REFERENCE_CALLS == ref_calls and nonfinite == 0
            and float(img_a.std()) > 0.0):
        raise AssertionError("the config 5 sessions are not one uninterrupted session")
    return dict(k1=k1, s_per_sample=prog["s_per_sample_this_session"], k1_per_frame=k1 / frames,
                hops_per_frame=prog["alpha_hops_this_session"] / frames)


def phase_courtyard2(device, card, env, tmp):
    """Phase 7i, the 1.1M-triangle courtyard2 (the courtyard at density 2)
    through the port at 1920x1080: its bench build, K1 and K2 against their
    plain versions on its tables and view, the 1080p step, the 128x72
    window card against CPU, one Renderer frame of its GLB in each
    backend and visibility, and the bench on it. Returns its K1 and K2
    numbers, launches and the bench's detail."""
    import dataclasses

    import torch

    from gltf_renderer_tpu_torch.bench_scene import (COURTYARD_GOLDEN_RES, COURTYARD_VIEW,
                                                     build_bench_scene, build_courtyard_probe,
                                                     golden_renderer)
    from gltf_renderer_tpu_torch.ops import raster
    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import rasterizer as rz
    from gltf_renderer_tpu_torch.scene.procedural import write_courtyard_glb

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene, meta, settings, params, c2w, n_tris = build_bench_scene(
        *FULL_RES, device=device, scene_kind="courtyard2")
    log(f"[courtyard2] {n_tris} triangles, stack bound {meta.stack_bound} (K1 takes at most "
        f"{tr.max_stack_bound()}), {scene.wide_nodes.shape[0]} wide nodes, "
        f"{scene.leaf_records.shape[0]} leaves, has_masked={meta.has_masked}, built in "
        f"{time.perf_counter() - t0:.2f}s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB card={card}")
    if n_tris != COURTYARD2_TRIS or not meta.has_masked:
        raise AssertionError("the courtyard2 scene is not the bench's")

    # K1 against its plain version on its tables at the kernel table's two
    # launch sizes, timed; K2 against its plain version on its tiled view.
    sets = bench_traverse.ray_sets(scene, meta, params, c2w, bench_traverse.RAYS_RES, device)
    k1 = {rays[0]: k1_main_size(scene, meta, rays, "[courtyard2] kernel")
          for rays in (sets[0], sets[2])}
    del sets
    k2 = raster_view("courtyard2", scene.world, c2w, timed=True)

    run = scene_steps("courtyard2", scene, meta, settings, params, c2w, COURTYARD2_TIMED_STEPS,
                      card)
    log(f"[courtyard2] max_memory_allocated after the steps "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    del scene
    torch.cuda.empty_cache()

    # The golden configuration's 128x72 window, card against CPU, seeds 0-1.
    built = {str(dev): build_courtyard_probe(2, dev) for dev in ("cpu", device)}
    for seed in (0, 1):
        imgs = {}
        for dev, (p_scene, p_meta, p_set, p_par, p_c2w, _) in built.items():
            img, st = pt.trace(p_scene, p_meta, p_set, p_par, p_c2w, COURTYARD_GOLDEN_RES, seed,
                               with_stats=True)
            imgs[dev] = img.cpu().numpy()
            if not np.isfinite(imgs[dev]).all() or float(st[1]) != 0.0:
                raise AssertionError(f"courtyard2's window on {dev} is not finite")
        frac, rel, ok = images_match(imgs[str(device)], imgs["cpu"])
        log(f"[courtyard2] {COURTYARD_GOLDEN_RES[0]}x{COURTYARD_GOLDEN_RES[1]} window seed "
            f"{seed} card vs CPU: {frac:.5f} of pixels within atol 1e-4 + rtol 1e-3, means "
            f"{rel:.2e} apart")
        if not ok:
            raise AssertionError("courtyard2's window on the card disagrees with the CPU")
    del built

    # One Renderer frame of its GLB in each backend and visibility.
    w, h = FULL_RES
    t0 = time.perf_counter()
    path = write_courtyard_glb(os.path.join(tmp, "courtyard2.glb"), density=2)
    written_s = time.perf_counter() - t0
    r = golden_renderer(path, w, h, "pathtracer", COURTYARD_VIEW, device,
                        pt_kw=dict(max_bounces=2, min_bounces=2, alpha_shadows=True), env=env)
    loaded_s = time.perf_counter() - t0 - written_s
    frames = {}
    for backend, vis in (("pathtracer", None), ("rasterizer", "raycast"),
                         ("rasterizer", "tiled")):
        r.settings = dataclasses.replace(r.settings, backend=backend)
        if vis:
            r.raster_visibility = vis
        k1_0, k2_0 = tr.KERNEL_LAUNCHES, raster.KERNEL_LAUNCHES
        hops0 = pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS + rz.RASTER_RETRY_HOPS
        ref0 = tr.REFERENCE_CALLS
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = r.draw_frame()
        ms = (time.perf_counter() - t1) * 1e3
        got = (tr.KERNEL_LAUNCHES - k1_0, raster.KERNEL_LAUNCHES - k2_0,
               pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS + rz.RASTER_RETRY_HOPS - hops0)
        chunks = stream_chunks(w, h, rz.RASTER_CHUNK)
        want = {"pathtracer": (3 * stream_chunks(w, h, pt.RAY_CHUNK) + got[2], 0),
                "raycast": (chunks + got[2], 0),
                "tiled": (got[2], 1)}[vis or backend]
        name = vis or backend
        frames[name] = got
        log(f"[courtyard2] Renderer frame {w}x{h} {name} (GLB through Renderer.load_scene(path)"
            f"{', spp 1, with the tables built' if not vis else ''}): {ms:.1f} ms, K1 launches "
            f"{got[0]} (expected {want[0]}: hops {got[2]}), K2 {got[1]} (expected {want[1]}); "
            f"u8 mean {float(img.mean()):.3f} card={card}")
        if (got[:2] != want or img.shape != (h, w, 3) or float(img.std()) == 0.0
                or tr.REFERENCE_CALLS != ref0):
            raise AssertionError(f"courtyard2's Renderer {name} frame is wrong")
    log(f"[courtyard2] GLB {os.path.getsize(path)} bytes written in {written_s:.2f}s, loaded "
        f"in {loaded_s:.2f}s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    del r
    torch.cuda.empty_cache()

    bench = phase_bench("courtyard2", steps=COURTYARD2_TIMED_STEPS)
    log(f"[courtyard2] bench alpha hops {bench['alpha_hops']}, traversal launches "
        f"{bench['kernel_launches']['traverse_wide']}, step_s {bench['step_s']}")
    return dict(k1=k1, k2=k2, launches=run["launches"] + sum(f[0] for f in frames.values()),
                k2_launches=sum(f[1] for f in frames.values()), bench=bench)


def phase_furnace(device, card):
    """Phase 7j, the furnace check of tests/test_ssim_baseline.py at
    1920x1080: the diffuse box under a uniform environment rasterized, and
    path traced to FURNACE_SPP samples (trace_chunked at SPP a dispatch,
    4 bounces); the two at that test's bar (windowed SSIM >= 0.99 after a
    4x4 box downsample, means within 2%). Returns the K1 launches."""
    import torch

    from gltf_renderer_tpu_torch.bench_scene import build_furnace_scene, furnace_scores
    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import rasterizer as rz
    from gltf_renderer_tpu_torch.render import settings as S

    w, h = FULL_RES
    scene, meta, settings, params, c2w, cam_pos = build_furnace_scene(w, h, device)
    k1_0 = tr.KERNEL_LAUNCHES
    raster_img = rz.render(scene, meta, S.RenderSettings(), params, c2w, cam_pos, (w, h), 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = torch.zeros((h, w, 3), dtype=torch.float64, device=device)
    nan = torch.zeros((), device=device)
    dispatches = FURNACE_SPP // SPP
    for i in range(dispatches):
        img, st = pt.trace_chunked(scene, meta, settings, params, c2w, (w, h), i,
                                   with_stats=True, spp=SPP)
        acc += img
        nan = nan + st[1]
    traced = (acc / dispatches).float().cpu().numpy()
    pt_s = time.perf_counter() - t0
    launches = tr.KERNEL_LAUNCHES - k1_0
    score, rel = furnace_scores(raster_img.cpu().numpy(), traced)
    log(f"[furnace] {w}x{h} diffuse box under a uniform environment: path tracer "
        f"{FURNACE_SPP} spp ({dispatches} dispatches of {SPP}, chunks of {pt.RAY_CHUNK} rays, "
        f"{settings.max_bounces} bounces) "
        f"in {pt_s:.2f}s, raster frame raycast; windowed SSIM (4x4 downsampled) {score:.6f} "
        f"(bar 0.99), means {rel:.5f} apart (bar 0.02), nan_inf={float(nan):.0f}; K1 "
        f"launches {launches} card={card}")
    if score < 0.99 or rel >= 0.02 or float(nan) != 0.0 or not np.isfinite(traced).all():
        raise AssertionError("the furnace's converged path tracer and raster frame disagree")
    return launches


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
    """Per-lane fetch kernels vs plain at the tool's shapes; both kernels'
    study (tools.bench_perlane.study: graph-replay and profiler device time
    at every shape, in turns with PARENT_PERLANE's kernels where that source
    exists, the steps sweep, SASS, clocks); then the tool's main path.
    Returns their two kernel-table rows."""
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
        # The one-hot product reads the first 8 columns of every row (a
        # non-finite entry anywhere poisons the sums), the shuffle kernel the
        # columns of the ids its lanes visit.
        o_bytes = nbytes(ids, got) + n * perlane.SUM_COLS * 2
        s_bytes = nbytes(s_ids, s_got) + int(s_visited.sum()) * c * 4
        plain[label] = {
            "onehot": (cuda_ms(lambda: perlane.onehot_fetch_ref(ids, table, steps), 3),
                       bound(o_bytes, OPS_ONEHOT_LANE_STEP * ids.numel() * steps)),
            "shuffle": (cuda_ms(lambda: perlane.shuffle_fetch_ref(s_ids, s_table, n, c, steps), 3),
                        bound(s_bytes, c * perlane.LANES * steps)),
        }

    parent = PARENT_PERLANE if os.path.exists(PARENT_PERLANE) else None
    if parent is None:
        log(f"[perlane] no parent kernel source at {PARENT_PERLANE}, parent not timed")
    study = bp.study(device, parent)
    for name, ops in study["sass"].items():
        log(f"[sass] {name}: opcodes " + ", ".join(f"{k} {v}" for k, v in ops.items()))
    device_us = {}
    for kind in bp.KINDS:
        row = study[kind]["shapes"][PERLANE_ROW]
        sweep = study[kind]["sweep"]["new"]
        device_us[kind] = {"graph_us": statistics.mean(row["new_graph_us"]),
                           "profiler_us": row["new_profiler_us"][0],
                           "profiler_launches": row["new_profiler_us"][1],
                           "slope_ns": sweep["slope_ns"], "intercept_us": sweep["intercept_us"],
                           "steps0_us": sweep["steps0_us"], "k6_graph_us": study["k6_graph_us"],
                           "graph_us_by_shape": {lab: statistics.mean(r["new_graph_us"])
                                                 for lab, r in study[kind]["shapes"].items()}}
        if parent:
            device_us[kind].update(
                parent_graph_us=statistics.mean(row["parent_graph_us"]),
                parent_slope_ns=study[kind]["sweep"]["parent"]["slope_ns"],
                parent_intercept_us=study[kind]["sweep"]["parent"]["intercept_us"])

    # The tool's main path: its launches counted from 0. The study above
    # captured CUDA graphs, whose replays launch kernels that the counters
    # saw once, at capture; it runs before the counters are reset.
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
            f"({row['us_step']:.3f} us/step; 16 calls back to back, launch-bound) "
            f"plain={p_ms:.3f} ms bound={b_ms:.6f} ms ({b_by}); "
            f"latency floor {floor_ms:.6f} ms ({bp.STEPS} dependent loads in place, at most "
            f"{row['l1_hit_ceiling']:.3f} of them L1 hits, or staged in shared memory, "
            f"whichever is less)")
        if row["label"] == PERLANE_ROW:
            dev = device_us[row["kind"]]
            device_ms = dev["graph_us"] * 1e-3
            log(f"[perlane] {row['kind']} {PERLANE_ROW}: device time a call {device_ms:.6f} ms, "
                f"{device_ms / floor_ms:.2f}x its latency floor; " + bp.format_numbers(
                    {k: v for k, v in dev.items() if k != "graph_us_by_shape"}, 4))
            out[row["kind"]] = {"ms": row["ms"], "plain_ms": p_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "device_ms": device_ms,
                                "latency_floor_ms": floor_ms,
                                "floor_ratio": device_ms / floor_ms,
                                "l1_hit_ceiling": row["l1_hit_ceiling"],
                                "hit_latency_ns": row["hit_latency_ns"],
                                **{k: v for k, v in dev.items() if k != "graph_us"}}
    log(f"[perlane] tool launches={launches}; the kernel table's rows are the {PERLANE_ROW} "
        f"shape, ms the tool's own timing (16 calls back to back, launch-bound), device_ms "
        f"the device time a call (CUDA graph replay)")
    common = {"route": "cuda", "source": "gltf_renderer_tpu_torch/csrc/perlane.cu",
              "max_abs_err": 0.0, "library_ms": None}
    return [dict(common, name="onehot_fetch", replaces=ONEHOT_REPLACES,
                 launches=launches["onehot_fetch"], **out["onehot"]),
            dict(common, name="shuffle_fetch", replaces=SHUFFLE_REPLACES,
                 launches=launches["shuffle_fetch"], **out["shuffle"])]


def phase_bench(scene_kind="helmet", steps=2):
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
    from gltf_renderer_tpu_torch.ops import _build

    body = next(lines for name, lines in _build.sass("brute.cu").items()
                if name.startswith("_Z") and "ILb0E" in name)
    ops = [_build.opcode(x) for x in body]
    counts = {op: ops.count(op) for op in sorted(set(ops))}
    if not counts.get("HGMMA"):
        raise AssertionError("the brute-force kernel has no wgmma (HGMMA) instruction")
    return counts


def build_kernels():
    """Build every kernel library at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    from gltf_renderer_tpu_torch.ops import _build

    sources = SOURCES + tuple(p for p in (PARENT_K1, PARENT_K2, PARENT_K3, PARENT_PERLANE)
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

    worst_abs, times, chunk_rays = phase_kernel_vs_plain(scene, meta, params, c2w, device)
    phase_fidelity(scene, meta, settings, params)
    launches, mrays, _ = phase_main_path(scene, meta, settings, params, c2w, card)
    k2 = phase_raster_kernel(scene)
    helmet_ssim = phase_raster_fidelity(device)
    frames = phase_raster_frame(scene, meta, params, c2w, card)
    log(f"[done] phases 1-7 in {time.perf_counter() - t_start:.1f}s")
    t0 = time.perf_counter()
    court = phase_courtyard(device, card)
    log(f"[done] phase 7b in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    zoo = phase_materials(device, card)
    log(f"[done] phase 7c in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    blend = phase_raster_blend(device, card)
    log(f"[done] phase 7d in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        env = phase_env_io(device, tmp)
        glb = phase_loaded_courtyard(device, card, env, tmp)
        anim = phase_animation(device, card, env)
        log(f"[done] phase 7e in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        app = phase_app(device, card, env, tmp, court, blend)
        log(f"[done] phase 7f in {time.perf_counter() - t0:.1f}s; K1 launches {app['k1']}")
        t0 = time.perf_counter()
        shard = phase_sharded(device, card, env, tmp, scene.world)
        log(f"[done] phase 7g in {time.perf_counter() - t0:.1f}s; K1 launches {shard['k1']} "
            f"(both ranks' included), K2 launches {shard['k2']}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        config5 = phase_config5(device, card, tmp)
        log(f"[done] phase 7h in {time.perf_counter() - t0:.1f}s; K1 launches {config5['k1']}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        court2 = phase_courtyard2(device, card, env, tmp)
        log(f"[done] phase 7i in {time.perf_counter() - t0:.1f}s; K1 launches "
            f"{court2['launches']}, K2 launches {court2['k2_launches']}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    furnace_k1 = phase_furnace(device, card)
    log(f"[done] phase 7j in {time.perf_counter() - t0:.1f}s; K1 launches {furnace_k1}")
    log(f"[goldens] each drawn once through Renderer.load_scene(path) (bar {RASTER_SSIM_BAR}): "
        f"box_raster {blend['ssim']}, helmet_raster {helmet_ssim}, anim_pose "
        f"{anim['ssim']:.6f}, materials_pt {zoo['ssim']:.6f}, courtyard_pt {court['ssim']:.6f}")
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
    z_lane = zoo["k1"]["lane_mixed"]
    c_k2 = court["k2"]
    c2_lane, c2_prim, c2_k2 = court2["k1"]["lane_mixed"], court2["k1"]["primary"], court2["k2"]
    r_op, r_bl = blend["k1"]["raster_opaque"], blend["k1"]["raster_blend"]
    r_frames = [f for scene_frames in blend["frames"].values() for f in scene_frames.values()]
    print(json.dumps({"kernels": [{
        "name": "traverse_wide", "route": "cuda",
        "source": "gltf_renderer_tpu_torch/csrc/traverse.cu", "replaces": REPLACES,
        "launches": launches + court["launches"] + zoo["launches"]
        + sum(frames[v][0] for v in frames) + sum(f[0] for f in r_frames) + glb["launches"]
        + anim["k1"] + app["k1"] + shard["k1"] + config5["k1"] + court2["launches"]
        + furnace_k1,
        "max_abs_err": max(worst_abs, anim["worst_abs"],
                           *(x["max_abs"] for x in court["k1"].values()),
                           *(x["max_abs"] for x in zoo["k1"].values()),
                           *(x["max_abs"] for x in blend["k1"].values()),
                           *(x["max_abs"] for x in court2["k1"].values())),
        "ms": lane["ms"], "plain_ms": lane["plain_ms"], "bound_ms": lane["bound_ms"],
        "bound_by": lane["bound_by"], "library_ms": None, "launcher_ms": lane["launcher_ms"],
        "courtyard_ms": c_lane["ms"], "courtyard_plain_ms": c_lane["plain_ms"],
        "courtyard_bound_ms": c_lane["bound_ms"], "courtyard_bound_by": c_lane["bound_by"],
        "materials_ms": z_lane["ms"], "materials_plain_ms": z_lane["plain_ms"],
        "materials_bound_ms": z_lane["bound_ms"], "materials_bound_by": z_lane["bound_by"],
        "raster_opaque_ms": r_op["ms"], "raster_opaque_plain_ms": r_op["plain_ms"],
        "raster_opaque_bound_ms": r_op["bound_ms"], "raster_opaque_bound_by": r_op["bound_by"],
        "raster_blend_ms": r_bl["ms"], "raster_blend_plain_ms": r_bl["plain_ms"],
        "raster_blend_bound_ms": r_bl["bound_ms"], "raster_blend_bound_by": r_bl["bound_by"],
        "courtyard2_ms": c2_lane["ms"], "courtyard2_plain_ms": c2_lane["plain_ms"],
        "courtyard2_bound_ms": c2_lane["bound_ms"], "courtyard2_bound_by": c2_lane["bound_by"],
        "courtyard2_primary_ms": c2_prim["ms"], "courtyard2_primary_plain_ms": c2_prim["plain_ms"],
        "courtyard2_primary_bound_ms": c2_prim["bound_ms"],
        "courtyard2_launches": court2["launches"],
        "chunk_rays_identical": {"helmet": chunk_rays, "courtyard": court["chunk_rays"]},
    }, {
        "name": "raster_tiles", "route": "cuda",
        "source": "gltf_renderer_tpu_torch/csrc/raster.cu", "replaces": RASTER_REPLACES,
        "launches": frames["tiled"][1] + sum(f[1] for f in r_frames) + anim["k2"] + shard["k2"]
        + court2["k2_launches"],
        "max_abs_err": max(k2["err"], c_k2["err"], c2_k2["err"]),
        "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None, "bound_all_px_ms": k2["bound_all_px_ms"],
        "launcher_ms": k2["launcher_ms"], "parent_launcher_ms": k2["parent_ms"],
        "courtyard_ms": c_k2["ms"], "courtyard_plain_ms": c_k2["plain_ms"],
        "courtyard_bound_ms": c_k2["bound_ms"], "courtyard_bound_by": c_k2["bound_by"],
        "courtyard_bound_all_px_ms": c_k2["bound_all_px_ms"],
        "courtyard_launcher_ms": c_k2["launcher_ms"],
        "courtyard_parent_launcher_ms": c_k2["parent_ms"],
        "courtyard2_ms": c2_k2["ms"], "courtyard2_plain_ms": c2_k2["plain_ms"],
        "courtyard2_bound_ms": c2_k2["bound_ms"], "courtyard2_bound_by": c2_k2["bound_by"],
        "courtyard2_crossers": c2_k2["crossers"], "courtyard2_launches": court2["k2_launches"],
    }, brute_row, *perlane_rows,
        dict(warm_row, launches=bench_detail["kernel_launches"]["add_one"]
             + court2["bench"]["kernel_launches"]["add_one"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
