"""Headless app shell (port of gltf_renderer_tpu/app/cli.py: Main.cpp +
Config.cpp CLI).

    python -m gltf_renderer_tpu_torch.app.cli --gltf scene.glb --output out.png

Reference flags kept: --width --height --gltf --environment-map
(Config.cpp:45-58). Added: --output, --backend, --spp, --animation/--time
for scripted animation, orbit-camera parameters, tone map / exposure and
debug-output selection (the ImGui Graphics tab, Main.cpp:224-340, as flags).
Renders on the CUDA card; `main(argv, device="cpu")` renders on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gltf-renderer-tpu-torch",
        description="glTF 2.0 renderer on CUDA (raster + path tracer)",
    )
    p.add_argument("--gltf", type=str, help="path to .gltf/.glb scene")
    p.add_argument("--environment-map", type=str, help="path to .exr/.hdr equirect")
    p.add_argument("--width", type=int, default=1280)   # Config.cpp:11
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--output", type=str, default="out.png")
    p.add_argument("--backend", choices=["pathtracer", "rasterizer"], default="pathtracer")
    p.add_argument("--spp", type=int, default=64, help="accumulated samples (PT)")
    p.add_argument("--max-bounces", type=int, default=2)
    p.add_argument("--min-bounces", type=int, default=2)
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--tonemapper", choices=["agx", "none"], default="agx")
    p.add_argument("--environment-intensity", type=float, default=1.0)
    p.add_argument("--luminance-clamp", type=float, default=20.0)
    p.add_argument("--debug-output", type=int, default=0, help="0-27 (PathTracer channels)")
    p.add_argument("--animation", type=int, default=None, help="animation index")
    p.add_argument("--time", type=float, default=0.0, help="animation time (s)")
    p.add_argument("--scene-index", type=int, default=None)
    # Orbit camera (CameraController.h defaults).
    p.add_argument("--orbit-azimuth", type=float, default=0.5)
    p.add_argument("--orbit-inclination", type=float, default=-0.4)
    p.add_argument("--orbit-radius", type=float, default=None, help="default: 2.5x scene radius")
    p.add_argument("--camera", type=int, default=None, help="use glTF camera index")
    p.add_argument("--frames", type=int, default=1, help="animation frames to write")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--shard", choices=["off", "auto"], default="off",
                   help="auto: shard rendering over every visible device (one device: "
                        "unsharded; several: not ported yet)")
    p.add_argument("--profile", action="store_true",
                   help="print a per-pass ms table each frame")
    p.add_argument("--trace-dir", type=str, default=None,
                   help="capture a torch.profiler trace of the render to this dir")
    return p


def save_png(path: str, img_u8: np.ndarray):
    from PIL import Image

    Image.fromarray(img_u8, "RGB").save(path)


def scene_bounds(scene):
    """(centre, radius) of the scene's posed world vertices (host build),
    (0, 1) for a scene without geometry."""
    from gltf_renderer_tpu_torch.scene import flatten

    tf = flatten.compute_global_transforms(scene)
    plan = flatten.build_instance_plan(scene)
    if not len(plan.vertex_map):
        return np.zeros(3), 1.0
    world = flatten.build_world_geometry(scene.pools, plan, tf, flatten.normal_transforms(tf),
                                         flatten.plan_tri_flags(plan, scene.primitives))
    wp = np.asarray(world.position)
    centre = 0.5 * (wp.min(0) + wp.max(0))
    return centre, float(np.linalg.norm(wp - centre, axis=-1).max())


def main(argv=None, device="cuda") -> int:
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    args = build_parser().parse_args(argv)

    from gltf_renderer_tpu_torch.camera import OrbitController
    from gltf_renderer_tpu_torch.render import settings as S
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    settings = S.RenderSettings(
        backend=args.backend,
        width=args.width,
        height=args.height,
        pt=S.PathTracerSettings(
            max_bounces=min(args.max_bounces, S.MAX_BOUNCES_HARD_CAP),
            min_bounces=min(args.min_bounces, S.MAX_BOUNCES_HARD_CAP),
            debug_output=args.debug_output,
        ),
        tonemap=S.ToneMapSettings(
            tonemapper=S.TONEMAPPER_AGX if args.tonemapper == "agx" else S.TONEMAPPER_NONE,
            exposure=args.exposure,
        ),
    )
    renderer = Renderer(settings, mesh="auto" if args.shard == "auto" else None, device=device)
    renderer.params = renderer.params._replace(
        environment_intensity=args.environment_intensity,
        luminance_clamp=args.luminance_clamp,
    )

    if not args.gltf:
        print("error: --gltf is required in headless mode", file=sys.stderr)
        return 2
    try:
        scene = renderer.load_scene(args.gltf, scene_id=args.scene_index)
    except (OSError, ValueError) as e:
        print(f"error: failed to load {args.gltf}: {e}", file=sys.stderr)
        return 1
    logging.info(
        "loaded %s: %d nodes, %d prims, %d tris, %d materials, %d animations",
        scene.name, len(scene.nodes), len(scene.primitives.material),
        len(scene.pools.tri_vertex), len(scene.materials.flags) - 1,
        len(scene.animations),
    )
    if args.environment_map:
        try:
            renderer.load_environment(args.environment_map)
        except (OSError, ValueError) as e:
            print(f"error: failed to load {args.environment_map}: {e}", file=sys.stderr)
            return 1

    if args.animation is not None and scene.animations:
        renderer.select_animation(args.animation)
        renderer.player.time = args.time
    else:
        renderer.player.animation = None

    # Frame the scene with an orbit camera around its bounds.
    centre, radius = scene_bounds(scene)
    if args.camera is not None and scene.cameras:
        # A glTF camera: the renderer re-derives world_to_view from the
        # camera node's (possibly animated) global transform every frame.
        from gltf_renderer_tpu_torch.scene import flatten

        renderer.select_camera(args.camera, viewport_aspect=args.width / args.height)
        node_id = renderer._track_camera_node
        if node_id is not None:
            tf = flatten.compute_global_transforms(scene)
            renderer.camera.world_to_view = np.linalg.inv(tf[node_id]).astype(np.float32)
    else:
        orbit = OrbitController(
            centre=centre,
            radius=args.orbit_radius if args.orbit_radius else 2.5 * radius,
            azimuth=args.orbit_azimuth,
            inclination=args.orbit_inclination,
        )
        renderer.camera.aspect_ratio = args.width / args.height
        renderer.camera.z_near = max(1e-3, 0.01 * radius)
        renderer.camera.world_to_view = orbit.world_to_view()

    renderer.profile = bool(args.profile)
    trace_cm = (renderer.capture_trace(args.trace_dir) if args.trace_dir
                else contextlib.nullcontext())
    base, ext = os.path.splitext(args.output)
    t0 = time.time()
    with trace_cm:
        for frame in range(args.frames):
            if args.backend == "pathtracer":
                img = None
                for _ in range(args.spp):
                    img = renderer.draw_frame(delta=0.0)
            else:
                img = renderer.draw_frame(delta=1.0 / args.fps if frame else 0.0)
            if args.profile and "pass_ms" in renderer.stats:
                parts = "  ".join(f"{k}={v:.1f}ms" for k, v in renderer.stats["pass_ms"].items())
                logging.info("frame %d passes: %s", frame, parts)
            out_path = args.output if args.frames == 1 else f"{base}_{frame:04d}{ext}"
            save_png(out_path, img)
            if args.frames > 1 and args.backend == "pathtracer":
                renderer.draw_frame(delta=1.0 / args.fps)  # advance the animation
    logging.info("rendered %d frame(s) in %.2fs -> %s", args.frames, time.time() - t0,
                 args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
