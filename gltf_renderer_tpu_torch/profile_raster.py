"""Where a 1080p raster frame spends its time, on one CUDA card.

    python -m gltf_renderer_tpu_torch.profile_raster

Builds the bench scene, renders two warm frames per visibility, then one
frame per visibility under torch.profiler and prints, for each: the frame's
wall time, the summed device kernel time (and so the device's busy share of
the traced frame), the number of kernel launches, host-to-device copies and
aten calls, and the ten kernels with the most device time.
"""

from __future__ import annotations

import sys
import time


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_raster: no CUDA device available", file=sys.stderr)
        return 2
    from gltf_renderer_tpu_torch import device as dev_mod
    from gltf_renderer_tpu_torch.bench_scene import build_bench_scene
    from gltf_renderer_tpu_torch.render import renderer
    from gltf_renderer_tpu_torch.render import settings as S

    w, h = 1920, 1080
    scene, meta, _, params, c2w, _ = build_bench_scene(w, h, device="cuda")
    rs = S.RenderSettings(backend="rasterizer", width=w, height=h)
    cam_pos = [1.1, -1.1, 0.6]

    def frame(vis, i):
        hdr = renderer.raster_step(scene, meta, rs, params, c2w, cam_pos, (w, h), i,
                                   visibility=vis)
        return renderer.post_step(hdr, rs.tonemap, rs.bloom, i)

    print(dev_mod.card_name_and_power_limit())
    for vis in ("tiled", "raycast"):
        for i in range(2):
            frame(vis, i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            frame(vis, 2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        device = [e for e in events if e.device_type.name == "CUDA"]
        busy_us = sum(e.self_device_time_total for e in device)
        launches = sum(e.count for e in device)
        aten = sum(e.count for e in events if e.key.startswith("aten::"))
        h2d = sum(e.count for e in device if "Memcpy HtoD" in e.key)
        print(f"[{vis}] traced frame {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
              f"({busy_us / 1e4 / wall:.1f}% of the frame), {launches} device activities, "
              f"{h2d} host-to-device copies, {aten} aten calls")
        for e in sorted(device, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"[{vis}]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
                  f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
