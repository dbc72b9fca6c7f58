"""One run of one cell: inputs from the seed, the program's set-up and its
measured window of `Renderer.draw_frame` calls, then the check against the
reference and, with tracing, the per-layer metrics.

The program is driven only through its public entry: a `Renderer` with
path-tracer settings, `load_scene(<the GLB the benchmark wrote>)`,
`load_environment(<the sky array>)`, the camera's world_to_view, y_fov and
z_near, and `draw_frame(seed=...)`. After the window the harness reads
the accumulated image (`Renderer._accum`), the last u8 frame, the frame
counters and, traced, each window frame's `Renderer.stats["pass_ms"]` and
`["counts"]`, the K1 launch counter and the two alpha-hop counters.

The check calls the reference package the configuration names
(perfbench/spec.py `reference`); the camera matrices both sides get are
the benchmark's own (perfbench/reference/pathtracer.py `look_at`,
`clip_to_world`) in every cell.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench import check, frames, spec
from perfbench.glb import write_glb
from perfbench.reference import pathtracer as ref_pt
from perfbench.roofline import k1_bytes

PROFILED_FRAMES = 2  # frames under torch.profiler in a traced run


def make_inputs(cell: spec.Cell):
    """The scene dict and the sky array of the cell's configuration."""
    cfg = cell.config
    scene = spec.scene_generator(cfg["scene"]["generator"], cell.here).build(
        **cfg["scene"]["params"])
    sky = spec.sky_generator(cfg["sky"]["generator"], cell.here).build(**cfg["sky"]["params"])
    return scene, sky


def _renderer(cell, glb, sky, view, device):
    from gltf_renderer_tpu_torch.render import settings as S
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    cfg = cell.config
    r = Renderer(S.RenderSettings(backend="pathtracer", width=cfg["width"], height=cfg["height"],
                                  pt=S.PathTracerSettings(**cfg["pt"])), device=device)
    r.load_scene(glb)
    r.load_environment(sky)
    cam = cfg["camera"]
    r.camera.world_to_view = view
    r.camera.y_fov = math.radians(cam["y_fov_deg"])
    r.camera.z_near = cam["z_near"]
    return r


def _counters(pt_mod, traverse_mod):
    return traverse_mod.KERNEL_LAUNCHES, pt_mod.ALPHA_RETRY_HOPS + pt_mod.ALPHA_SHADOW_HOPS


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda"):
    """Returns (result dict, check lines). The window draws frames until
    `seconds` have passed, and at least one."""
    cfg = cell.config
    width, height = cfg["width"], cfg["height"]
    traffic = frames.Traffic(cell.traffic, seed)
    scene, sky = make_inputs(cell)
    spec.reference(cell.reference, cell.here)  # imported here, outside set-up and the window
    view = ref_pt.look_at(cfg["camera"]["eye"], cfg["camera"]["target"])
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    cuda = torch.device(device).type == "cuda"
    try:
        glb = write_glb(os.path.join(tmp, "scene.glb"), scene)
        if cuda:
            torch.cuda.reset_peak_memory_stats()

        # -- set-up: imports, extensions, load, environment, warm frames --
        t0 = time.perf_counter()
        from gltf_renderer_tpu_torch.ops import traverse as traverse_mod
        from gltf_renderer_tpu_torch.render import pathtracer as pt_mod

        r = _renderer(cell, glb, sky, view, device)
        seeds = []
        img = None
        for i in range(traffic.warm_frames):
            seeds.append(traffic.frame_seed(i))
            img = r.draw_frame(seed=seeds[-1])
        setup_s = time.perf_counter() - t0

        # -- the measured window --
        recorder = None
        profile_info = None
        pass_ms, frame_ms, counts = [], [], []
        if trace:
            r.profile = True
            from perfbench.trace import K1Recorder
            recorder = K1Recorder(pt_mod).__enter__()
        k1_0, hops_0 = _counters(pt_mod, traverse_mod)
        n = 0
        t_start = time.perf_counter()
        while True:
            seeds.append(traffic.frame_seed(traffic.warm_frames + n))
            img = r.draw_frame(seed=seeds[-1])
            n += 1
            if trace:
                frame_ms.append(r.stats["frame_ms"])
                pass_ms.append(dict(r.stats.get("pass_ms", {})))
                counts.append(dict(r.stats.get("counts", {})))
            if time.perf_counter() - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start
        k1_1, hops_1 = _counters(pt_mod, traverse_mod)
        peak_bytes = int(torch.cuda.max_memory_allocated()) if cuda else 0
        if trace:
            # After the window, without the spans' synchronizations: frames
            # under the profiler, device activity only (busy time, device
            # ops, K1's per-launch time), then one with host operations too
            # (what the host did in the longest idle gaps).
            r.profile = False

            def more_frames(count):
                nonlocal img
                for _ in range(count):
                    seeds.append(traffic.frame_seed(len(seeds)))
                    img = r.draw_frame(seed=seeds[-1])

            profile_info = _profiled(more_frames, traverse_mod, recorder, cuda)
            recorder.__exit__(None, None, None)
            launches = recorder.launches()

        # -- what the window produced --
        acc_frames = r.accumulated_frames
        frame_index = r.frame_index - 1
        px, py = check.sample_pixels(seed, width, height, int(cell.limits["pixels"]))
        prog_acc = r._accum[torch.as_tensor(py, device=r._accum.device),
                            torch.as_tensor(px, device=r._accum.device)].cpu().numpy()
        prog_u8 = np.asarray(img)[py, px]
        del r, img
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # -- the reference, on the same inputs --
        t_ref = time.perf_counter()
        nums = reference_numbers(cell, scene, sky, view, seeds[-acc_frames:], frame_index,
                                 px, py, prog_acc, prog_u8, device)
        ref_s = time.perf_counter() - t_ref
        correct, checks = check.verdict(nums, cell.limits["limits"])

        kind = torch.cuda.get_device_name(0) if cuda else "cpu"
        metrics = {}
        if not trace:
            rate = n * width * height / window_s / 1e6
            values = {"pt_msamples_per_s": rate, "setup_s": setup_s}
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                       "memory_peak_bytes": peak_bytes}
        result = {"correct": bool(correct), "attempted": n, "failed": 0}
        if trace:
            ctx = {"frames": n, "frame_ms": frame_ms, "pass_ms": pass_ms, "counts": counts,
                   "k1_launches": k1_1 - k1_0, "alpha_hops": hops_1 - hops_0,
                   "frame_s": window_s / n, "k1_calls": len(launches),
                   "k1_bytes": sum(k1_bytes(*c) for c in launches),
                   "k1_mean_s": profile_info["k1_mean_s"], "kind": kind,
                   "profiled_frames": PROFILED_FRAMES,
                   "device": {"busy_s": profile_info["busy_s"],
                              "window_s": profile_info["window_s"]}}
            for m in cell.per_layer:
                v = spec.metric_reader(m["name"], cell.here)(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            device_info["busy_s"] = profile_info["busy_s"]
            device_info["window_s"] = profile_info["window_s"]
        result["metrics"] = metrics
        result["device"] = device_info
        lines = [f"reference check of {len(px)} pixels over {acc_frames} frames: "
                 f"{ref_s:.1f} s"]
        if trace:
            result["breakdown"] = profile_info["breakdown"]
            lines.append("K1 launches the profiler recorded {k1_recorded}, dropped {k1_dropped}, "
                         "mean {k1_mean_s!r} s".format(**profile_info))
            live = sorted(c[4] for c in launches) or [0]
            lines.append(f"K1 launches {len(launches)}, live rays a launch min {live[0]} "
                         f"median {live[len(live) // 2]} max {live[-1]}; profiled frames "
                         f"{profile_info['window_s'] / PROFILED_FRAMES!r} s a frame, busy "
                         f"{profile_info['busy_s'] / PROFILED_FRAMES!r} s; window "
                         f"{window_s / n!r} s a frame")
        result["checks"] = checks
        lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
        return result, lines
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _profiled(more_frames, traverse_mod, recorder, cuda):
    from torch.profiler import ProfilerActivity, profile

    from perfbench.trace import read_profile

    device = [ProfilerActivity.CUDA] if cuda else []
    k1_0 = traverse_mod.KERNEL_LAUNCHES
    with profile(activities=device or [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        more_frames(PROFILED_FRAMES)
        window_s = time.perf_counter() - t0
    info = read_profile(prof, traverse_mod.KERNEL_LAUNCHES - k1_0, window_s,
                        recorder.event_mean_s() if cuda else None)
    with profile(activities=[ProfilerActivity.CPU] + device) as prof:
        more_frames(1)
    info["breakdown"]["idle_gaps"] = read_profile(prof, 0, 0.0)["breakdown"]["idle_gaps"]
    return info


def reference_numbers(cell, scene, sky, w2v, seeds, frame_index, px, py, prog_acc, prog_u8,
                      device, control: bool = False):
    """The compared numbers of the program's outputs against the reference
    the configuration names (or, with control, of that reference in the
    control's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cell.config
    res = (cfg["width"], cfg["height"])
    c2w = ref_pt.clip_to_world(w2v, math.radians(cfg["camera"]["y_fov_deg"]),
                               res[0] / res[1], cfg["camera"]["z_near"])
    ref_render = spec.reference(cell.reference, cell.here)
    settings = ref_render.settings(cfg["pt"])
    ref = ref_render.build_scene(scene, sky, device)
    acc = ref_render.accumulate(ref, settings, c2w, res, px, py, seeds)
    ref_acc = acc.cpu().numpy()
    ref_u8 = ref_render.frame_u8(acc, px, py, frame_index).cpu().numpy()
    if control:
        ctl = ref_render.build_scene(scene, sky, device, control=True)
        cacc = ref_render.accumulate(ctl, settings, c2w, res, px, py, seeds)
        prog_acc = cacc.cpu().numpy()
        prog_u8 = ref_render.frame_u8(cacc, px, py, frame_index).cpu().numpy()
    return check.numbers(prog_acc, prog_u8, ref_acc, ref_u8)
