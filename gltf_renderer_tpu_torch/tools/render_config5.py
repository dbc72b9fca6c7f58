"""BASELINE config 5: the courtyard (Sponza-class) at 1920x1080, path
traced to 1,024 accumulated spp with alpha shadows, in resumable sessions
(port of tools/render_config5.py).

    python -m gltf_renderer_tpu_torch.tools.render_config5 [--frames 1024]
        [--ckpt-every 32] [--width 1920] [--height 1080] [--out build/config5_torch]

The progressive accumulation is checkpointed every --ckpt-every frames and
at the end (Renderer.save_state: the state the reference cannot persist,
Pathtracer.cpp:259-272). Running the command again resumes from the
checkpoint in --out: it draws one frame so that the scene tables and the
reset key exist, then restores the accumulation over it, so the resumed
frames are the uninterrupted run's, bit for bit. --frames is the target,
so a long render can be cut into sessions (--frames 512, then --frames
1024). Each file is written whole and then renamed over the old one, so a
session stopped at any point loses only the frames since its last
checkpoint.

Writes into --out: config5_courtyard.ckpt.npz (the resume state),
config5_courtyard.png (tone mapped) and config5_progress.json (spp,
target_spp, wall_s summed over the sessions, resolution, scene,
s_per_sample_this_session, and this session's frames, traversal kernel
launches and alpha hops).

Renders on the CUDA card; `main(argv, device="cpu")` renders on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

CKPT = "config5_courtyard.ckpt.npz"
PNG = "config5_courtyard.png"
PROGRESS = "config5_progress.json"
SCENE = "courtyard (Sponza-class, alpha shadows)"
SKY_HW = (256, 512)  # the bench's analytic sky, as bench.build_bench_scene draws it


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", type=int, default=1024, help="target accumulated spp")
    p.add_argument("--ckpt-every", type=int, default=32)
    p.add_argument("--out", default=os.path.join("build", "config5_torch"))
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    return p


def make_renderer(glb: str, width: int, height: int, device="cuda", env=None):
    """A Renderer on `glb` set up as BASELINE config 5: the path tracer, 2
    bounces, alpha shadows, the bench's analytic sky (or the EnvMaps `env`),
    a 60-degree lens with z_near 0.01 down the courtyard's colonnade."""
    from gltf_renderer_tpu_torch.bench_scene import COURTYARD_VIEW, analytic_sky
    from gltf_renderer_tpu_torch.camera import look_at
    from gltf_renderer_tpu_torch.render import settings as S
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    rs = S.RenderSettings(backend="pathtracer", width=width, height=height,
                          pt=S.PathTracerSettings(max_bounces=2, min_bounces=2,
                                                  alpha_shadows=True))
    r = Renderer(rs, device=device)
    r.load_scene(glb)
    if env is None:
        r.load_environment(analytic_sky(*SKY_HW))
    else:
        r.env = env
    r.camera.y_fov = np.pi / 3
    r.camera.aspect_ratio = width / height
    r.camera.z_near = 0.01
    r.camera.world_to_view = look_at(*COURTYARD_VIEW)
    return r


def _replace(path: str, write):
    """write(a temporary name beside `path`), then rename it over `path`."""
    tmp = os.path.join(os.path.dirname(path), ".partial." + os.path.basename(path))
    write(tmp)
    os.replace(tmp, path)


def run(renderer, frames: int, ckpt_every: int, out: str):
    """Accumulate `renderer`'s frames until it holds `frames` spp, resuming
    from the checkpoint in `out` when there is one; checkpoint every
    `ckpt_every` spp and at the end. Returns the last progress written, or
    None when the checkpoint already held `frames` spp."""
    from PIL import Image

    from gltf_renderer_tpu_torch.ops import traverse as tr
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    os.makedirs(out, exist_ok=True)
    ckpt, png, prog = (os.path.join(out, n) for n in (CKPT, PNG, PROGRESS))
    prior_s = 0.0
    if os.path.exists(ckpt):
        renderer.draw_frame()
        renderer.load_state(ckpt)
        if os.path.exists(prog):
            with open(prog) as f:
                prior_s = float(json.load(f).get("wall_s", 0.0))
        print(f"[config5] resumed at {renderer.accumulated_frames} spp ({prior_s:.1f}s prior "
              f"wall-clock)", flush=True)
    start_spp = renderer.accumulated_frames
    k1_0, hops_0 = tr.KERNEL_LAUNCHES, pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS
    t0 = t_report = time.time()
    state = None
    while renderer.accumulated_frames < frames:
        img = renderer.draw_frame()
        spp = renderer.accumulated_frames
        if spp % ckpt_every == 0 or spp >= frames:
            _replace(ckpt, renderer.save_state)
            session_s = time.time() - t0
            drawn = spp - start_spp
            state = {
                "spp": spp,
                "target_spp": frames,
                "wall_s": prior_s + session_s,
                "resolution": [renderer.settings.width, renderer.settings.height],
                "scene": SCENE,
                "s_per_sample_this_session": session_s / drawn,
                "frames_this_session": drawn,
                "k1_launches_this_session": tr.KERNEL_LAUNCHES - k1_0,
                "alpha_hops_this_session": (pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS
                                            - hops_0),
            }

            def write_progress(path):
                with open(path, "w") as f:
                    json.dump(state, f, indent=1)

            _replace(prog, write_progress)
            _replace(png, Image.fromarray(img).save)
            if time.time() - t_report > 60:
                print(f"[config5] {state}", flush=True)
                t_report = time.time()
    if state is not None:
        print(f"[config5] DONE: {state['spp']} spp in {state['wall_s']:.1f}s total; this session "
              f"{state['frames_this_session']} frames, {state['s_per_sample_this_session']:.4f} "
              f"s a sample, {state['k1_launches_this_session'] / state['frames_this_session']:.2f}"
              f" K1 launches and {state['alpha_hops_this_session'] / state['frames_this_session']:.2f}"
              f" alpha hops a frame -> {png}", flush=True)
    return state


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)

    from gltf_renderer_tpu_torch.ops import warm
    from gltf_renderer_tpu_torch.scene.procedural import write_courtyard_glb

    warm.warm(device)
    with tempfile.TemporaryDirectory(prefix="config5_") as d:
        glb = write_courtyard_glb(os.path.join(d, "courtyard.glb"), density=1)
        renderer = make_renderer(glb, args.width, args.height, device)
    run(renderer, args.frames, args.ckpt_every, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
