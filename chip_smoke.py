#!/usr/bin/env python3
"""Smoke run of the torch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
1. device and build: the card's name and power limit (nvidia-smi), then the
   BVH traversal kernel built from gltf_renderer_tpu_torch/csrc/traverse.cu;
2. kernel vs plain PyTorch version on the bench scene's tables, for primary,
   bounce-like and lane-mixed ray sets under every cull/blend mode, and both
   timed at the main path's launch sizes;
3. fidelity: the 256x144 probe (mean of seeds 1..32) against the committed
   CPU golden tests/goldens/bench_fidelity.npy by SSIM (bar 0.995), no NaN/Inf;
4. the main path at full size: 1920x1080, trace_chunked(spp=4), one warm
   step and three timed steps, with the kernel launch counter reset first.

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
FULL_RES = (1920, 1080)
SPP = 4
TIMED_STEPS = 3
SSIM_BAR = 0.995
WORD_AGREE_BAR = 0.9999
REL_TOL = 1e-6
REPLACES = "gltf_renderer_tpu/ops/pallas_trace.py:123"


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
        times[rays[0]] = (o.shape[0], ms_k, ms_p)
        log(f"[kernel] time {rays[0]} rays={o.shape[0]} kernel={ms_k:.3f} ms "
            f"plain={ms_p:.3f} ms")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from gltf_renderer_tpu_torch import device as dev_mod
    from gltf_renderer_tpu_torch.bench_scene import build_bench_scene
    from gltf_renderer_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = dev_mod.card_name_and_power_limit()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load("traverse.cu")
    log(f"[build] traverse.cu -> {_build.library_path('traverse.cu')} in "
        f"{time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    scene, meta, settings, params, c2w, n_tris = build_bench_scene(*FULL_RES, device=device)
    log(f"[scene] {n_tris} triangles, stack bound {meta.stack_bound}, "
        f"{scene.wide_nodes.shape[0]} wide nodes, {scene.leaf_records.shape[0]} leaves, "
        f"built in {time.perf_counter() - t0:.2f}s")

    worst_abs, times = phase_kernel_vs_plain(scene, meta, settings, params, c2w, device)
    phase_fidelity(scene, meta, settings, params)
    launches, mrays, _ = phase_main_path(scene, meta, settings, params, c2w, card)

    n_lane, ms_k, ms_p = times["lane_mixed"]
    print(json.dumps({"kernels": [{
        "name": "traverse_wide", "route": "cuda",
        "source": "gltf_renderer_tpu_torch/csrc/traverse.cu", "replaces": REPLACES,
        "launches": launches, "max_abs_err": worst_abs, "ms": ms_k, "plain_ms": ms_p,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
