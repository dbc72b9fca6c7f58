"""The bench, golden and raster-fidelity configurations, built without JAX.

`build_bench_scene` mirrors bench.py:23-125. `scene_kind="helmet"`: the
DamagedHelmet-class textured sphere (~49k triangles, one 512^2 base-colour
texture, metallic 0.3 / roughness 0.45) seen from (1.1, -1.1, 0.6); the same
scene feeds the raster frame at 1080p. `"courtyard"` / `"courtyard2"`: the
Sponza-class courtyard at density 1 / 2 (273,856 / ~1.1M triangles, five
materials, alpha-MASKed banners) seen down the colonnade from
(-9, 0, 1.7), with alpha shadows on. Both: the analytic HDR sky at cube
size 128, env NEE + MIS with 2 bounces and the luminance clamp. The
courtyard skips the raster-only environment prefilters.

The five golden configurations (tests/golden_configs.py, goldens in
tests/goldens/) are drawn through the port's Renderer, each from a file
the port's writers write and `Renderer.load_scene(path)` reads, set up as
golden_configs._renderer sets up the JAX renderer (`golden_renderer`):
`render_box_raster_golden` (the box and its point light rasterized at
256x256), `helmet_raster_renderer` (the textured sphere GLB under the
32x64 analytic environment, to be rasterized at 192x108), `render_anim_pose_golden`
(the skinned strip and the morph cube at 128x96, one bounce, the first frame
at delta 0.5, three more at delta 0, side by side), `render_materials_golden`
(the zoo under the analytic environment, 160x120, eight frames) and
`render_courtyard_golden` (the courtyard GLB at tex_size 64, 128x72, two
frames, alpha shadows). The raster ones draw with the Renderer's
`raster_visibility`: raycast as the JAX renderer draws, or tiled.

`build_courtyard_probe` is the courtyard golden configuration's scene at
any density (courtyard2's 128x72 window, card against CPU), and
`build_furnace_scene` / `furnace_scores` the furnace check of
tests/test_ssim_baseline.py: a diffuse box under a uniform environment,
where the raster frame and the converged path tracer have one answer.

`build_materials_scene` is the material zoo (`materials_scene`) under the
golden configurations' 32x64 analytic environment, seen from (0, -6, 3),
with env NEE + MIS and 2 bounces; `render_debug_channels` renders its 28
debug outputs at 64x48 with one bounce and seed 5, as
tests/golden_configs.py::render_debug_channels does for
tests/goldens/debug_channels.npz.

`build_raster_scene` builds the zoo or the courtyard (tex_size 256) for the
raster backend: the analytic environment with the GGX and diffuse
prefilters the raster IBL samples, seen from the zoo's golden view or down
the courtyard's colonnade.

`AnimatedScene` is a loaded scene posed by a Renderer's `_update_geometry`
(advance the player, pose the nodes, skin and morph on the device, rebuild
the world, build the path tracer's tables at the first frame and refit
them after), without the frame. `build_animated_scene` loads the skinned
strips (`write_skinned_gltf`, 64 strips by default) or the morph cube
(`write_morph_gltf`) through the port's loader.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from gltf_renderer_tpu_torch import camera
from gltf_renderer_tpu_torch.env.environment import DIFFUSE_RESOLUTION, build_environment_pt
from gltf_renderer_tpu_torch.render import pathtracer as pt
from gltf_renderer_tpu_torch.render import settings as S
from gltf_renderer_tpu_torch.render.renderer import Renderer
from gltf_renderer_tpu_torch.scene import flatten
from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.scene.gltf import load_gltf
from gltf_renderer_tpu_torch.scene.procedural import (
    courtyard_scene,
    materials_scene,
    textured_sphere_scene,
    write_box_gltf,
    write_courtyard_glb,
    write_materials_gltf,
    write_morph_gltf,
    write_skinned_gltf,
    write_textured_sphere_glb,
)

FIDELITY_RES = (256, 144)  # bench.FIDELITY_RES
FIDELITY_SPP = 32          # bench.FIDELITY_SPP: seeds 1..32 averaged
RASTER_FIDELITY_RES = (192, 108)  # golden_configs.render_helmet_raster
COURTYARD_GOLDEN_RES = (128, 72)   # golden_configs.render_courtyard_pt
COURTYARD_GOLDEN_FRAMES = 2
MATERIALS_GOLDEN_RES = (160, 120)  # golden_configs.render_materials_pt
MATERIALS_GOLDEN_FRAMES = 8
DEBUG_CHANNELS_RES = (64, 48)      # golden_configs.render_debug_channels
N_DEBUG_OUTPUTS = 28
BOX_RASTER_RES = (256, 256)       # golden_configs.render_box_raster
ANIM_GOLDEN_RES = (128, 96)       # golden_configs.render_anim_pose, each half
ANIM_GOLDEN_FRAMES = 4            # draw_frame(delta=0.5), then three at delta 0
ANIM_KINDS = ("skinned", "morph")
# (eye, target) of the anim_pose golden views, and of the 1080p runs: the
# strips' row seen whole, the morph cube from the golden view
ANIM_GOLDEN_VIEWS = {"skinned": ([0.0, -3.0, 1.0], [0.0, 0.0, 1.0]),
                     "morph": ([2.0, -2.0, 1.5], [0.0, 0.0, 0.0])}
ANIM_VIEWS = {"skinned": ([18.9, -24.0, 5.0], [18.9, 0.0, 1.0]),
              "morph": ANIM_GOLDEN_VIEWS["morph"]}
SCENE_KINDS = ("helmet", "courtyard", "courtyard2")
RASTER_SCENE_KINDS = ("materials", "courtyard")
# (eye, target) of the views the bench and golden configurations share
COURTYARD_VIEW = ([-9.0, 0.0, 1.7], [1.0, 0.0, 1.6])  # down the colonnade
MATERIALS_VIEW = ([0.0, -6.0, 3.0], [0.0, 0.0, 0.5])  # the zoo's golden view
FURNACE_EYE = [2.0, -2.0, 1.5]  # the furnace check's view, at the origin
FURNACE_RADIANCE = 0.8
FURNACE_PT = dict(max_bounces=4, min_bounces=4, point_lights=False,
                  luminance_clamp_enabled=False)


def analytic_sky(h: int = 256, w: int = 512) -> np.ndarray:
    """The bench's analytic HDR sky (sun hotspot + gradient), (h, w, 3) f32."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    z = 1.0 - 2.0 * vv
    phi = 2 * np.pi * uu
    s = np.sqrt(np.maximum(1 - z * z, 0))
    d3 = np.stack([s * np.cos(phi), s * np.sin(phi), z], -1)
    sun = np.asarray([0.5, 0.3, 0.8])
    sun /= np.linalg.norm(sun)
    hotspot = 50.0 * np.maximum((d3 * sun).sum(-1), 0.0) ** 200
    sky = 0.4 + 0.6 * np.maximum(d3[..., 2], 0)
    return np.stack([hotspot + 0.8 * sky, hotspot + 0.85 * sky, hotspot + sky],
                    -1).astype(np.float32)


def world_from_scene(scene):
    """Host flatten: (WorldGeometry, GpuLights) of a Scene."""
    tf = flatten.compute_global_transforms(scene)
    plan = flatten.build_instance_plan(scene)
    tri_flags = flatten.plan_tri_flags(plan, scene.primitives)
    world = flatten.build_world_geometry(scene.pools, plan, tf,
                                         flatten.normal_transforms(tf), tri_flags)
    return world, flatten.gather_lights(scene, tf)


def bench_camera(width: int, height: int, scene_kind: str = "helmet") -> np.ndarray:
    """clip_to_world of the bench camera: eye (1.1, -1.1, 0.6) at the
    origin (helmet), or down the courtyard's colonnade."""
    if scene_kind.startswith("courtyard"):
        w2v = camera.look_at(*COURTYARD_VIEW)
    else:
        w2v = camera.look_at([1.1, -1.1, 0.6], [0.0, 0.0, 0.0])
    return camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=width / height, z_near=0.01)


def build_bench_scene(width: int, height: int, device="cuda", scene_kind: str = "helmet",
                      tex_size: int = None, n_lat: int = 128, n_lon: int = 192,
                      sky_hw=(256, 512), cube_size: int = 128,
                      diffuse_size: int = DIFFUSE_RESOLUTION):
    """Bench scene + camera on `device`. The keyword sizes default to the
    bench's (tex_size: 512 for the helmet, 256 for the courtyard; n_lat and
    n_lon shape the helmet only); tests pass smaller ones. Returns
    (ptscene, meta, settings, params, clip_to_world, n_tris)."""
    if scene_kind not in SCENE_KINDS:
        raise ValueError(f"unknown bench scene {scene_kind!r}, expected one of {SCENE_KINDS}")
    courtyard = scene_kind.startswith("courtyard")
    if courtyard:
        scene = courtyard_scene(density=2 if scene_kind == "courtyard2" else 1,
                                tex_size=256 if tex_size is None else tex_size)
    else:
        scene = textured_sphere_scene(tex_size=512 if tex_size is None else tex_size,
                                      n_lat=n_lat, n_lon=n_lon, metallic=0.3, roughness=0.45)
    world, lights = world_from_scene(scene)
    env = build_environment_pt(analytic_sky(*sky_hw), cube_size=cube_size, device=device,
                               diffuse_size=diffuse_size, prefilters=not courtyard)
    ptscene, meta = pt.make_pt_scene(world, scene.materials, scene.textures, lights, env=env,
                                     device=device)
    settings = S.PathTracerSettings(max_bounces=2, min_bounces=2, alpha_shadows=courtyard)
    return (ptscene, meta, settings, S.PathTracerParams(),
            bench_camera(width, height, scene_kind), int(world.tri_vertex.shape[0]))


def analytic_equirect(h: int = 32, w: int = 64) -> np.ndarray:
    """The golden configurations' smooth low-dynamic-range environment
    (tests/golden_configs.py::_analytic_equirect), (h, w, 3) f32."""
    v = (np.arange(h) + 0.5) / h
    z = 1.0 - 2.0 * v
    eq = np.stack([0.5 + 0.2 * z, 0.5 + 0.1 * z, 0.5 - 0.1 * z], -1).astype(np.float32)
    return np.broadcast_to(eq[:, None, :], (h, w, 3)).copy()


def raster_camera(eye, width: int, height: int):
    """(clip_to_world, camera position) looking at the origin from `eye`,
    with the golden configurations' lens (60 degrees, z_near 0.01)."""
    w2v = camera.look_at(eye, [0.0, 0.0, 0.0])
    c2w = camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=width / height, z_near=0.01)
    return c2w, camera.position(w2v)


def golden_renderer(path, width: int, height: int, backend: str, view, device="cuda",
                    pt_kw=None, env=None, mesh=None):
    """A Renderer on `path` set up as tests/golden_configs.py::_renderer
    sets up the JAX one: `backend` at width x height, PathTracerSettings
    from pt_kw, the environment `env` (EnvMaps on `device`, or None), the
    default 60-degree lens with z_near 0.01, looking from view[0] at
    view[1]; `mesh` as Renderer takes it."""
    rs = S.RenderSettings(backend=backend, width=width, height=height,
                          pt=S.PathTracerSettings(**(pt_kw or {})))
    r = Renderer(rs, mesh=mesh, device=device)
    r.env = env
    r.load_scene(path)
    r.camera.aspect_ratio = width / height
    r.camera.z_near = 0.01
    r.camera.world_to_view = camera.look_at(*view)
    return r


def draw_frames(renderer, frames: int):
    """`frames` frames of `renderer` at delta 0. Returns the last (h, w, 3)
    uint8 frame and the summed [ray_count, nan_count] of the path tracer's
    samples since the scene was loaded."""
    img = None
    for _ in range(frames):
        img = renderer.draw_frame()
    return img, renderer.ray_stats


def render_box_raster_golden(device="cuda", visibility: str = "raycast"):
    """The box-raster golden configuration through the Renderer: the box
    file, rasterized at 256x256 from (2, -2, 1.5) with `visibility`.
    Returns the (256, 256, 3) uint8 frame."""
    w, h = BOX_RASTER_RES
    with tempfile.TemporaryDirectory() as d:
        r = golden_renderer(write_box_gltf(os.path.join(d, "box.gltf")), w, h, "rasterizer",
                            ([2.0, -2.0, 1.5], [0.0, 0.0, 0.0]), device)
    r.raster_visibility = visibility
    return r.draw_frame()


def helmet_raster_renderer(device, env):
    """The helmet-raster golden configuration's Renderer: the textured
    sphere GLB (metallic 0.4, roughness 0.35) under `env` (the analytic
    environment's EnvMaps with its prefilters, on `device`), rasterized at
    192x108 from (1.2, -1.2, 0.8). Its draw_frame gives the (108, 192, 3)
    uint8 frame."""
    w, h = RASTER_FIDELITY_RES
    with tempfile.TemporaryDirectory() as d:
        path = write_textured_sphere_glb(os.path.join(d, "sphere.glb"), metallic=0.4,
                                         roughness=0.35)
        return golden_renderer(path, w, h, "rasterizer", ([1.2, -1.2, 0.8], [0.0, 0.0, 0.0]),
                               device, env=env)


def build_raster_scene(scene_kind: str, width: int, height: int, device="cuda",
                       diffuse_size: int = DIFFUSE_RESOLUTION):
    """The zoo ("materials") or the courtyard ("courtyard") for the raster
    backend on `device`. Returns (ptscene, meta, render_settings, params,
    clip_to_world, camera_pos, resolution), raster_step's arguments."""
    if scene_kind not in RASTER_SCENE_KINDS:
        raise ValueError(f"unknown raster scene {scene_kind!r}, "
                         f"expected one of {RASTER_SCENE_KINDS}")
    if scene_kind == "materials":
        scene, view = materials_scene(), MATERIALS_VIEW
    else:
        scene, view = courtyard_scene(), COURTYARD_VIEW
    w2v = camera.look_at(*view)
    world, lights = world_from_scene(scene)
    env = build_environment_pt(analytic_equirect(), device=device, diffuse_size=diffuse_size)
    ptscene, meta = pt.make_pt_scene(world, scene.materials, scene.textures, lights, env=env,
                                     device=device)
    c2w = camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=width / height, z_near=0.01)
    rs = S.RenderSettings(backend="rasterizer", width=width, height=height)
    return ptscene, meta, rs, S.PathTracerParams(), c2w, camera.position(w2v), (width, height)


def render_courtyard_golden(device="cuda"):
    """The courtyard golden configuration through the Renderer: the
    courtyard GLB (tex_size 64) under the analytic environment, two frames
    down the colonnade. Returns `draw_frames`' (uint8 frame, stats)."""
    w, h = COURTYARD_GOLDEN_RES
    with tempfile.TemporaryDirectory() as d:
        path = write_courtyard_glb(os.path.join(d, "courtyard.glb"), tex_size=64)
        r = golden_renderer(path, w, h, "pathtracer", COURTYARD_VIEW, device,
                            pt_kw=dict(max_bounces=2, min_bounces=2, alpha_shadows=True),
                            env=build_environment_pt(analytic_equirect(), device=device,
                                                     prefilters=False))
    return draw_frames(r, COURTYARD_GOLDEN_FRAMES)


def build_courtyard_probe(density: int = 2, device="cuda"):
    """The courtyard golden configuration's scene at `density`, built in
    memory (`courtyard_scene(density, tex_size=64)`) under the analytic
    environment, with its settings (2 bounces, alpha shadows) and its
    128x72 view down the colonnade: a window to hold the card's render
    of the 1.1M-triangle courtyard2 (density 2) against the CPU's. Returns
    (ptscene, meta, settings, params, clip_to_world, n_tris), as
    build_bench_scene does."""
    scene = courtyard_scene(density=density, tex_size=64)
    world, lights = world_from_scene(scene)
    env = build_environment_pt(analytic_equirect(), device=device, prefilters=False)
    ptscene, meta = pt.make_pt_scene(world, scene.materials, scene.textures, lights, env=env,
                                     device=device)
    return (ptscene, meta, S.PathTracerSettings(max_bounces=2, min_bounces=2, alpha_shadows=True),
            S.PathTracerParams(), bench_camera(*COURTYARD_GOLDEN_RES, "courtyard"),
            int(world.tri_vertex.shape[0]))


def build_furnace_scene(width: int, height: int, device="cuda"):
    """tests/test_ssim_baseline.py::test_furnace_raster_vs_converged_pt's
    scene: the unit box, diffuse (base colour 0.65, roughness 1, no light),
    under a uniform environment of radiance FURNACE_RADIANCE (16x32, cube
    16, with the raster prefilters), seen from (2, -2, 1.5). The raster's
    split-sum IBL is exact for a constant environment, so its frame and the
    converged path tracer's (4 bounces, no clamp) have one answer. Returns
    (ptscene, meta, path-tracer settings, params, clip_to_world, camera
    position)."""
    with tempfile.TemporaryDirectory() as d:
        scene = load_gltf(write_box_gltf(os.path.join(d, "box.gltf"),
                                         base_color=(0.65, 0.65, 0.65, 1.0), roughness=1.0,
                                         with_light=False))
    world, lights = world_from_scene(scene)
    env = build_environment_pt(np.full((16, 32, 3), FURNACE_RADIANCE, np.float32), cube_size=16,
                               device=device)
    ptscene, meta = pt.make_pt_scene(world, scene.materials, scene.textures, lights, env=env,
                                     device=device)
    c2w, cam_pos = raster_camera(FURNACE_EYE, width, height)
    return ptscene, meta, S.PathTracerSettings(**FURNACE_PT), S.PathTracerParams(), c2w, cam_pos


def furnace_scores(raster, traced):
    """(windowed SSIM, relative difference of the means) of a raster frame
    and a converged path-traced image of the furnace scene, as
    test_furnace_raster_vs_converged_pt scores them: both (h, w, 3) HDR
    box-downsampled 4x4 first (the path tracer's residual noise and the
    raster's aliased silhouette both average out), SSIM over the larger
    maximum as the data range. Its bar: SSIM >= 0.99, means within 2%."""
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    def down4(x):
        h, w, c = x.shape
        return x[:h // 4 * 4, :w // 4 * 4].reshape(h // 4, 4, w // 4, 4, c).mean((1, 3))

    ra = down4(np.asarray(raster, np.float32))
    tr = down4(np.asarray(traced, np.float32))
    score = ssim(ra, tr, data_range=float(max(ra.max(), tr.max())))
    rel = abs(float(np.mean(raster)) - float(np.mean(traced))) / float(np.mean(traced))
    return float(score), rel


def materials_camera(width: int, height: int) -> np.ndarray:
    """clip_to_world of the material zoo's golden view, (0, -6, 3) looking
    at (0, 0, 0.5)."""
    w2v = camera.look_at(*MATERIALS_VIEW)
    return camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=width / height, z_near=0.01)


def build_materials_scene(width: int, height: int, device="cuda"):
    """The material zoo on `device` under the golden configurations'
    environment, 2 bounces. Returns (ptscene, meta, settings, params,
    clip_to_world, n_tris), as build_bench_scene does."""
    scene = materials_scene()
    world, lights = world_from_scene(scene)
    env = build_environment_pt(analytic_equirect(), device=device, prefilters=False)
    ptscene, meta = pt.make_pt_scene(world, scene.materials, scene.textures, lights, env=env,
                                     device=device)
    return (ptscene, meta, S.PathTracerSettings(max_bounces=2, min_bounces=2),
            S.PathTracerParams(), materials_camera(width, height),
            int(world.tri_vertex.shape[0]))


def render_materials_golden(device="cuda"):
    """The materials golden configuration through the Renderer: the zoo
    file under the analytic environment, eight frames from the zoo's golden
    view. Returns `draw_frames`' (uint8 frame, stats)."""
    w, h = MATERIALS_GOLDEN_RES
    with tempfile.TemporaryDirectory() as d:
        r = golden_renderer(write_materials_gltf(os.path.join(d, "zoo.gltf")), w, h,
                            "pathtracer", MATERIALS_VIEW, device,
                            pt_kw=dict(max_bounces=2, min_bounces=2),
                            env=build_environment_pt(analytic_equirect(), device=device,
                                                     prefilters=False))
    return draw_frames(r, MATERIALS_GOLDEN_FRAMES)


def render_debug_channels(device="cuda"):
    """The 28 debug outputs of the material zoo, raw floats before tone
    mapping: (28, h, w, 3) f32, channel 0 (DEBUG_NONE) the beauty render at
    one bounce, all with seed 5."""
    import torch

    res = DEBUG_CHANNELS_RES
    ptscene, meta, _, _, c2w, _ = build_materials_scene(*res, device)
    return torch.stack([
        pt.trace(ptscene, meta, S.PathTracerSettings(max_bounces=1, min_bounces=1,
                                                     debug_output=dbg),
                 S.PathTracerParams(), c2w, res, 5)
        for dbg in range(N_DEBUG_OUTPUTS)])


class AnimatedScene:
    """A loaded scene whose first animation drives the path tracer's tables
    on `device`: a Renderer's scene and `_update_geometry`, without the
    frame. `update(delta)` advances the player and poses the tables (built
    at the first call, refit after)."""

    def __init__(self, scene: T.Scene, device="cuda", env=None):
        self.renderer = Renderer(device=device)
        self.renderer.env = env
        self.renderer.load_scene(scene)

    def update(self, delta: float):
        """Advance the player by `delta` seconds and bring the tables to the
        new pose. Returns the node transforms."""
        r = self.renderer
        return r._update_geometry(r.player.tick(r.scene, delta) if r.player.animation else None)

    scene = property(lambda self: self.renderer.scene)
    player = property(lambda self: self.renderer.player)
    dynamic = property(lambda self: self.renderer._dynamic)
    ptscene = property(lambda self: self.renderer._ptscene)
    meta = property(lambda self: self.renderer._meta)
    bvh_host = property(lambda self: self.renderer._bvh_host)


def write_animated(kind: str, directory: str, strips: int = 1) -> str:
    """Write the skinned strips or the morph cube into `directory`."""
    if kind not in ANIM_KINDS:
        raise ValueError(f"unknown animated scene {kind!r}, expected one of {ANIM_KINDS}")
    if kind == "skinned":
        return write_skinned_gltf(os.path.join(directory, "skin.gltf"), strips=strips)
    return write_morph_gltf(os.path.join(directory, "morph.gltf"))


def anim_camera(kind: str, width: int, height: int, views=ANIM_VIEWS) -> np.ndarray:
    """clip_to_world of an animated scene's view (60 degrees, z_near 0.01)."""
    w2v = camera.look_at(*views[kind])
    return camera.clip_to_world(w2v, y_fov=np.pi / 3, aspect=width / height, z_near=0.01)


def build_animated_scene(kind: str, width: int, height: int, device="cuda", strips: int = 64,
                         env=None, time: float = 0.0):
    """The skinned strips (`strips` of them) or the morph cube, written and
    read back by the port's loader, posed at `time` seconds with the tables
    built there, under `env`. Returns (AnimatedScene, settings, params,
    clip_to_world): env NEE + MIS with 2 bounces, the kind's 1080p view."""
    with tempfile.TemporaryDirectory() as d:
        scene = load_gltf(write_animated(kind, d, strips))
    anim = AnimatedScene(scene, device, env=env)
    anim.update(time)
    return (anim, S.PathTracerSettings(max_bounces=2, min_bounces=2), S.PathTracerParams(),
            anim_camera(kind, width, height))


def render_anim_pose_golden(device="cuda"):
    """The anim_pose golden configuration through the Renderer: each
    scene's first frame at delta 0.5, three more at delta 0, the two
    images side by side. Returns the (96, 256, 3) uint8 image and the
    summed [ray_count, nan_count] of its samples."""
    w, h = ANIM_GOLDEN_RES
    halves, stats = [], 0.0
    for kind in ANIM_KINDS:
        with tempfile.TemporaryDirectory() as d:
            r = golden_renderer(write_animated(kind, d), w, h, "pathtracer",
                                ANIM_GOLDEN_VIEWS[kind], device,
                                pt_kw=dict(max_bounces=1, min_bounces=1))
        r.select_animation(0)
        r.draw_frame(delta=0.5)
        img, st = draw_frames(r, ANIM_GOLDEN_FRAMES - 1)
        halves.append(img)
        stats = stats + st
    return np.concatenate(halves, 1), stats
