#!/usr/bin/env python3
"""Smoke run of the torch port's main paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
1. device and build: the card's name and power limit (nvidia-smi), then both
   kernels built in parallel from gltf_renderer_tpu_torch/csrc/traverse.cu
   and csrc/raster.cu;
2. BVH traversal kernel vs its plain PyTorch version on the bench scene's
   tables, for primary, bounce-like and lane-mixed ray sets under every
   cull/blend mode, and both timed at the main path's launch sizes;
3. path-tracer fidelity: the 256x144 probe (mean of seeds 1..32) against the
   committed CPU golden tests/goldens/bench_fidelity.npy by SSIM (bar
   0.995), no NaN/Inf;
4. the path tracer at full size: 1920x1080, trace_chunked(spp=4), one warm
   step and three timed steps, with the kernel launch counters reset first;
5. tile-rasterizer kernel vs its plain PyTorch version at 1920x1080 on the
   bench view and on a near-clipped view: tri, z, u and v bit-identical;
   pair and crosser counts beside their caps; both timed on the bench view;
6. raster fidelity: the helmet-raster golden configuration (192x108, frame
   0) through raster_step + post_step in both visibilities, against the
   committed CPU golden tests/goldens/helmet_raster.png by SSIM (bar 0.99);
7. the raster frame at full size: bench scene, 1920x1080, tiled visibility +
   bloom + AgX -> u8, one warm and three timed frames, then the same with
   raycast visibility; the tile kernel launches once per tiled frame and no
   plain version runs.

The second-to-last lines are the kernel table as JSON and the card's name
and power limit; the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "bench_fidelity.npy")
RASTER_GOLDEN = os.path.join(ROOT, "tests", "goldens", "helmet_raster.png")
FULL_RES = (1920, 1080)
SPP = 4
TIMED_STEPS = 3
SSIM_BAR = 0.995
RASTER_SSIM_BAR = 0.99  # tests/test_ssim_baseline.py's golden bar
WORD_AGREE_BAR = 0.9999
REL_TOL = 1e-6
REPLACES = "gltf_renderer_tpu/ops/pallas_trace.py:123"
RASTER_REPLACES = "gltf_renderer_tpu/ops/pallas_raster.py:248"
SOURCES = ("traverse.cu", "raster.cu")
NEAR_VIEW_EYE = ([0.52, 0.0, 0.0], [0.52, 1.0, 0.0])  # camera plane cuts the sphere

# Peak rates of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# f32 operations the kernels execute, counted from their sources (compares
# included): a BVH node visit tests 4 child boxes at 25 each; a leaf visit
# tests 16 triangles at 53 each; a live (triangle, tile) pair costs 29 per
# tile pixel before the depth test (edge functions, inside test,
# barycentrics, depth and its range test; the winner's u, v are not counted).
OPS_NODE_VISIT = 4 * 25
OPS_LEAF_VISIT = 16 * 53
OPS_PAIR_PIXEL = 29


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches, timed with CUDA events
    after one warm call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and f32
    operations over the f32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(int(t.numel()) * t.element_size() for t in tensors if t is not None)


def ray_sets(scene, meta, settings, params, c2w, res, device, seed=7):
    """(name, origin, direction, t_min, t_max, mode) sets from the bench
    view: primary rays, bounce-like rays from their hits, and a lane-mixed
    set (closest bounce rays + any-hit env-shadow rays), as the main path
    launches them."""
    import torch

    from gltf_renderer_tpu_torch.env import environment as env_ops
    from gltf_renderer_tpu_torch.ops import rng
    from gltf_renderer_tpu_torch.ops import sampling
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    w, h = res
    px, py, valid = pt._tile_order(w, h, device)
    jitter = rng.pt_random(px, py, seed, 0)[..., 0:2] - 0.5
    c2w_t = torch.as_tensor(np.asarray(c2w), device=device)
    origin, d_raw = pt.generate_camera_rays(px, py, (w, h), c2w_t, jitter)
    ray_len = torch.sqrt(torch.clamp((d_raw * d_raw).sum(-1), min=1e-20))
    direction = d_raw / ray_len[:, None]
    t_min = torch.where(valid, torch.zeros_like(ray_len), ray_len + 1.0)
    prim = pt.trace_closest(scene, meta, origin, direction, t_min, ray_len)
    attrs = pt.fetch_hit_attributes(scene.world, prim.tri, prim.u, prim.v, direction)
    hit = prim.tri >= 0
    o_b = pt.offset_ray(attrs.position, attrs.geometric_normal)
    d_b = sampling.sample_cosine_hemisphere(attrs.geometric_normal,
                                            rng.pt_random(px, py, seed, 1)[..., 0:2])
    far = torch.full_like(ray_len, params.max_ray_length)
    tmin_b = torch.where(hit, torch.zeros_like(far), far + 1.0)
    d_s, _, _ = env_ops.env_sample(scene.env, rng.pt_random(px, py, seed, 2))
    mode = torch.cat([torch.zeros_like(px), torch.ones_like(px)]).to(torch.int32)
    return [
        ("primary", origin, direction, t_min, ray_len, None),
        ("bounce", o_b, d_b, tmin_b, far, None),
        ("lane_mixed", torch.cat([o_b, o_b]), torch.cat([d_b, d_s]),
         torch.cat([tmin_b, tmin_b]), torch.cat([far, far]), mode),
    ]


def compare(scene, meta, rays, cull, blend):
    """Kernel vs plain on one ray set. Returns (n_closest, n_word_agree,
    max_abs_err_t, max_rel_err_tuv, occlusion_mismatches)."""
    import torch

    from gltf_renderer_tpu_torch.ops import traverse as tr

    _, o, d, tmn, tmx, mode = rays
    any_hit = "lane" if mode is not None else False
    args = (scene.wide_nodes, scene.wide_maps.meta, scene.leaf_records, scene.leaf_words,
            o, d, tmn, tmx, meta.wide_root, any_hit, cull, blend, mode)
    k = tr.traverse_wide(*args, stack_bound=meta.stack_bound)
    p = tr.traverse_wide_ref(*args, stack_bound=meta.stack_bound)
    closest = torch.ones_like(tmn, dtype=torch.bool) if mode is None else mode == 0
    kt, kw, ku, kv = k
    pt_, pw, pu, pv = p
    agree = closest & (kw == pw)
    max_abs = 0.0
    max_rel = 0.0
    for a, b in ((kt, pt_), (ku, pu), (kv, pv)):
        diff = torch.abs(a - b)[agree]
        if diff.numel():
            rel = diff / torch.clamp(torch.abs(b[agree]), min=1e-30)
            max_rel = max(max_rel, float(torch.where(diff == 0, torch.zeros_like(rel), rel).max()))
            if a is kt:
                max_abs = float(diff.max())
    occ_bad = int(((kw >= 0) != (pw >= 0))[~closest].sum()) if mode is not None else 0
    return int(closest.sum()), int(agree.sum()), max_abs, max_rel, occ_bad


def phase_kernel_vs_plain(scene, meta, settings, params, c2w, device):
    import torch

    from gltf_renderer_tpu_torch.ops import traverse as tr

    sets = ray_sets(scene, meta, settings, params, c2w, (256, 144), device)
    worst_abs = 0.0
    for rays in sets:
        for cull in (-1, 0, 1):
            for blend in (0, 1, 2):
                n, agree, max_abs, max_rel, occ_bad = compare(scene, meta, rays, cull, blend)
                frac = agree / max(n, 1)
                log(f"[kernel] {rays[0]:10s} cull={cull:+d} blend={blend} closest={n} "
                    f"word_agree={frac:.6f} max_rel_tuv={max_rel:.3e} occ_mismatch={occ_bad}")
                if frac < WORD_AGREE_BAR or max_rel > REL_TOL or occ_bad:
                    raise AssertionError(f"kernel disagrees with plain version on {rays[0]} "
                                         f"cull={cull} blend={blend}")
                worst_abs = max(worst_abs, max_abs)

    # Times at the main path's launch sizes: 1080p spp=4 chunks are 262144
    # primary rays and 2 x 262144 merged bounce + shadow rays.
    big = ray_sets(scene, meta, settings, params, c2w, (512, 512), device)
    times = {}
    for rays in (big[0], big[2]):
        n, agree, max_abs, max_rel, occ_bad = compare(scene, meta, rays, 0, 0)
        log(f"[kernel] {rays[0]:10s} rays={rays[1].shape[0]} word_agree={agree / max(n, 1):.6f} "
            f"max_rel_tuv={max_rel:.3e} occ_mismatch={occ_bad}")
        if agree / max(n, 1) < WORD_AGREE_BAR or max_rel > REL_TOL or occ_bad:
            raise AssertionError(f"kernel disagrees with plain version on {rays[0]} (main-path size)")
        worst_abs = max(worst_abs, max_abs)
        _, o, d, tmn, tmx, mode = rays
        args = (scene.wide_nodes, scene.wide_maps.meta, scene.leaf_records, scene.leaf_words,
                o, d, tmn, tmx, meta.wide_root, "lane" if mode is not None else False, 0, 0,
                mode)
        ms_k = cuda_ms(lambda: tr.traverse_wide(*args, stack_bound=meta.stack_bound), 20)
        ms_p = cuda_ms(lambda: tr.traverse_wide_ref(*args, stack_bound=meta.stack_bound), 2)
        visits = {}
        tr.traverse_wide_ref(*args, stack_bound=meta.stack_bound, visits=visits)
        n_bytes = nbytes(*args[:8], mode) + 16 * o.shape[0]
        n_ops = visits["node"] * OPS_NODE_VISIT + visits["leaf"] * OPS_LEAF_VISIT
        b_ms, b_by = bound(n_bytes, n_ops)
        times[rays[0]] = (o.shape[0], ms_k, ms_p, b_ms, b_by)
        log(f"[kernel] time {rays[0]} rays={o.shape[0]} kernel={ms_k:.3f} ms "
            f"plain={ms_p:.3f} ms node_visits={visits['node']} leaf_visits={visits['leaf']} "
            f"bytes={n_bytes} ops={n_ops} bound={b_ms:.4f} ms ({b_by})")
    return worst_abs, times


def phase_fidelity(scene, meta, settings, params):
    from gltf_renderer_tpu_torch.bench_scene import FIDELITY_RES, FIDELITY_SPP, bench_camera
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    w, h = FIDELITY_RES
    c2w = bench_camera(w, h)
    acc = np.zeros((h, w, 3), np.float64)
    nan = 0.0
    for s in range(1, FIDELITY_SPP + 1):
        img, stats = pt.trace(scene, meta, settings, params, c2w, (w, h), s, with_stats=True)
        acc += img.double().cpu().numpy()
        nan += float(stats[1])
    probe = (acc / FIDELITY_SPP).astype(np.float32)
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
    elapsed = sum(step_s)
    mrays = rays / elapsed / 1e6
    log(f"[main] {w}x{h} spp={SPP} warm={warm_s:.3f}s steps={[round(s, 4) for s in step_s]} "
        f"rays={rays:.0f} Mrays/s={mrays:.4f} nan_inf={nan:.0f} launches={launches} "
        f"card={card}")
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("main path image has the wrong shape or non-finite values")
    if launches <= 0 or tr.REFERENCE_CALLS != ref_calls:
        raise AssertionError("main path did not run through the traversal kernel only")
    return launches, mrays, step_s


def near_view(res):
    from gltf_renderer_tpu_torch import camera

    eye, target = NEAR_VIEW_EYE
    w2v = camera.look_at(eye, target)
    return camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=res[0] / res[1], z_near=0.01)


def live_pairs(ins, cull_sign=1):
    """(triangle, tile) pairs whose triangle the kernel does not skip (not
    culled, |area| > 1e-12): the pairs whose pixels cost work."""
    import torch

    n = int(ins.offsets[-1])
    r = ins.rows[ins.tri_list[:n].long()]
    ri = ins.rows_i[ins.tri_list[:n].long()]
    ax, ay, bx, by, cx, cy = (r[:, i] for i in range(6))
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    side = area > 0.0 if cull_sign > 0 else area <= 0.0
    culled = side & ((ri[:, 1] & 1) == 0) if cull_sign else torch.zeros_like(side)
    return int(((torch.abs(area) > 1e-12) & ~culled).sum())


def phase_raster_kernel(scene, device):
    """Tile kernel vs plain version at 1080p on two views; times on the
    bench view. Returns (worst abs error, kernel ms, plain ms, bound ms,
    bound by)."""
    import torch

    from gltf_renderer_tpu_torch import camera
    from gltf_renderer_tpu_torch.bench_scene import bench_camera
    from gltf_renderer_tpu_torch.ops import raster

    w, h = FULL_RES
    world = scene.world
    worst = 0.0
    timed = None
    for name, c2w in (("bench", bench_camera(w, h)), ("near_clipped", near_view(FULL_RES))):
        ins = raster.prepare_tiles(world.position, world.tri_vertex, camera.world_to_clip(c2w),
                                   w, h, double_sided=world.tri_double_sided)
        args = (ins.rows, ins.rows_i, ins.tri_list, ins.offsets, ins.tiles)
        got = raster.rasterize_tiles(*args, cull_sign=1)
        want = raster.rasterize_tiles_ref(*args, cull_sign=1)
        torch.cuda.synchronize()
        names = ("z", "tri", "u", "v")
        same = {n: bool(torch.equal(g.view(torch.int32), p.view(torch.int32)))
                for n, g, p in zip(names, got, want)}
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
        if name == "near_clipped" and crossers == 0:
            raise AssertionError("the near-clipped view clips no triangle")
        worst = max(worst, err)
        if name == "bench":
            ms_k = cuda_ms(lambda: raster.rasterize_tiles(*args, cull_sign=1), 20)
            ms_p = cuda_ms(lambda: raster.rasterize_tiles_ref(*args, cull_sign=1), 1)
            n_live = live_pairs(ins)
            n_valid = int(ins.offsets[-1])
            n_bytes = (nbytes(ins.rows, ins.rows_i, ins.offsets) + 4 * n_valid
                       + nbytes(*got))
            n_ops = n_live * raster.TILE_H * raster.TILE_W * OPS_PAIR_PIXEL
            b_ms, b_by = bound(n_bytes, n_ops)
            log(f"[raster] time bench kernel={ms_k:.4f} ms plain={ms_p:.3f} ms "
                f"live_pairs={n_live}/{n_valid} bytes={n_bytes} ops={n_ops} "
                f"bound={b_ms:.4f} ms ({b_by})")
            timed = (ms_k, ms_p, b_ms, b_by)
    return (worst,) + timed


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


def build_kernels():
    """Build every kernel library at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    from gltf_renderer_tpu_torch.ops import _build

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.load, SOURCES))


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

    t0 = time.perf_counter()
    scene, meta, settings, params, c2w, n_tris = build_bench_scene(*FULL_RES, device=device)
    log(f"[scene] {n_tris} triangles, stack bound {meta.stack_bound}, "
        f"{scene.wide_nodes.shape[0]} wide nodes, {scene.leaf_records.shape[0]} leaves, "
        f"built in {time.perf_counter() - t0:.2f}s")

    worst_abs, times = phase_kernel_vs_plain(scene, meta, settings, params, c2w, device)
    phase_fidelity(scene, meta, settings, params)
    launches, mrays, _ = phase_main_path(scene, meta, settings, params, c2w, card)
    r_err, r_ms, r_plain, r_bound, r_by = phase_raster_kernel(scene, device)
    phase_raster_fidelity(device)
    frames = phase_raster_frame(scene, meta, params, c2w, card)

    log(f"[done] phases 1-7 in {time.perf_counter() - t_start:.1f}s")
    n_lane, ms_k, ms_p, b_ms, b_by = times["lane_mixed"]
    print(json.dumps({"kernels": [{
        "name": "traverse_wide", "route": "cuda",
        "source": "gltf_renderer_tpu_torch/csrc/traverse.cu", "replaces": REPLACES,
        "launches": launches, "max_abs_err": worst_abs, "ms": ms_k, "plain_ms": ms_p,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }, {
        "name": "raster_tiles", "route": "cuda",
        "source": "gltf_renderer_tpu_torch/csrc/raster.cu", "replaces": RASTER_REPLACES,
        "launches": frames["tiled"][1], "max_abs_err": r_err, "ms": r_ms, "plain_ms": r_plain,
        "bound_ms": r_bound, "bound_by": r_by, "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
