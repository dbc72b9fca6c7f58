"""Top-level renderer orchestration (port of gltf_renderer_tpu/render/renderer.py,
Renderer::DrawFrame, Renderer.cpp:274-374).

A frame: host animation + node transforms -> skinning and morphing on the
device -> the world rebuilt on the device -> the path tracer's tables built
at the first frame and refitted after (scenes with skinned or morphed
meshes only) -> the path tracer's sample accumulated, or a raster frame ->
bloom (raster only), tone map and dither -> u8 copied to the host. The
copy is the frame's one intended wait for the device; everything before it
is queued on the device's stream.

With a mesh (parallel.sharding) the path tracer's sample and the raster
frame are drawn sharded over the mesh's cells, and every rank gets the
whole image; accumulation, post and the u8 copy run on it on every rank.
Over a process group every rank calls load_scene, load_environment and
draw_frame in the same order, and each call ends on every rank together
(parallel.distributed.together): a raise on one rank, in a load, in its
cells or after the frame's last gather, raises RankFailed on the others
within the call, and no rank is left waiting in a collective.

With `profile` on, a frame's `stats["pass_ms"]` holds the host ms of its
spans (utils.spans), each summed over the frame: the passes
`skin_and_refit`, `path_trace_scene` (or `draw_scene`) and
`post(bloom+tonemap)`, each ended by a synchronize while `profile` is on;
`u8_copy`; and the path tracer's `pt.chunk`, `pt.k1`, `pt.alpha_read`,
`pt.shade`, `pt.nee` and `pt.bsdf_sample` (render/pathtracer.py), those
that ran. `stats["counts"]` holds the frame's `k1_launches`, `alpha_hops`
(retry and alpha-shadow), `alpha_reads` (the alpha hop loops' blocking
reads of a device mask, one a `pt.alpha_read` span; not the frame's other
syncs), `chunks` (the path tracer's `_trace_rays` calls), `compactions`
(the bounces whose rows the path tracer compacted to the live lanes),
`live_lanes` (the lanes alive when each bounce's shading starts, summed on
the device and read once after the u8 copy) and `lanes_shaded` (the rows
each bounce shades, summed on the host).
Under a torch profiler the same spans, inside a `draw_frame` range, name
the frame's phases on the profiler's clock, with `profile` on or off.

`raster_step` and `post_step` are the raster and post steps on their own.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from gltf_renderer_tpu_torch.anim.animation import AnimationPlayer, LocalPose, rest_pose
from gltf_renderer_tpu_torch.anim.skinning import DynamicMeshState
from gltf_renderer_tpu_torch.camera import Camera
from gltf_renderer_tpu_torch.device import resolve, synchronize
from gltf_renderer_tpu_torch.env.environment import EnvMaps, build_environment
from gltf_renderer_tpu_torch.env.hdr_io import read_environment_image
from gltf_renderer_tpu_torch.ops import rng, traverse
from gltf_renderer_tpu_torch.parallel import distributed, sharding
from gltf_renderer_tpu_torch.post.bloom import bloom as bloom_op
from gltf_renderer_tpu_torch.post.tonemap import to_u8, tonemap
from gltf_renderer_tpu_torch.render import pathtracer as pt
from gltf_renderer_tpu_torch.render import rasterizer
from gltf_renderer_tpu_torch.render import settings as S
from gltf_renderer_tpu_torch.scene import flatten
from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.scene.gltf import load_gltf
from gltf_renderer_tpu_torch.utils import spans


def raster_step(scene, meta, settings: S.RenderSettings, params, c2w, cam_pos, resolution,
                frame, visibility: str = "raycast", mesh=None):
    """DrawScene -> (h, w, 3) HDR linear image on the scene's device: the
    opaque and alpha-tested pass, the background, and the blended and
    transmissive layers over the backdrop pyramid. With a mesh, sharded
    over its tiles (raycast visibility only)."""
    if mesh is None:
        return rasterizer.render(scene, meta, settings, params, c2w, cam_pos, resolution, frame,
                                 visibility=visibility)
    if visibility != "raycast":
        raise ValueError("a sharded raster frame needs the raycast visibility")
    return sharding.render_raster_sharded(scene, meta, settings, params, c2w, cam_pos,
                                          resolution, frame, mesh)


def post_step(hdr, tonemap_settings: S.ToneMapSettings, bloom_settings, frame):
    """Bloom (when enabled) + tone map + dither -> (h, w, 3) uint8."""
    img = hdr
    if bloom_settings is not None and bloom_settings.enabled:
        img = bloom_op(hdr, bloom_settings.max_mips, bloom_settings.strength)
    return to_u8(tonemap(img, tonemap_settings.tonemapper, tonemap_settings.exposure, frame))


def _counts():
    """(K1 launches, alpha-loop hops, path-tracer chunks, compacted
    bounces) so far, from the module counters."""
    return (traverse.KERNEL_LAUNCHES, pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS,
            pt.RAY_CHUNKS, pt.COMPACTIONS)


def _host_bytes(*tables) -> int:
    return int(sum(np.asarray(v).nbytes for t in tables for v in t if v is not None))


class Renderer:
    """Interactive / offline renderer state machine."""

    def __init__(self, settings: Optional[S.RenderSettings] = None, mesh=None, device="cuda",
                 *, _together=True):
        """mesh: None (one device, unsharded), "auto" (one tile a rank of
        the process group, parallel.distributed.initialize; unsharded in a
        world of 1), or a parallel.sharding.Mesh on this renderer's device
        type, used as given. Both backends draw through the sharded steps
        when a mesh is set. Sharded over a process group, loads and frames
        end on every rank together (distributed.together) unless
        `_together` is False: the viewer's loops, which load on rank 0
        before the other ranks, run their own exchanges."""
        self.settings = settings or S.RenderSettings()
        self.params = S.PathTracerParams()
        self.device = resolve(device)
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be None, 'auto' or a Mesh, got {mesh!r}")
            mesh = sharding.make_mesh(1, device=self.device)
            mesh = mesh if mesh.world_size > 1 else None
        elif mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device}, the renderer on {self.device}")
        self.mesh = mesh
        self._fail_together = _together
        self.scene: Optional[T.Scene] = None
        self.scene_id = 0
        self.env: Optional[EnvMaps] = None
        self.camera = Camera(aspect_ratio=self.settings.width / self.settings.height)
        self.player = AnimationPlayer()
        # The raster backend's visibility: "raycast", as the JAX renderer
        # draws; "tiled" runs the tile z-buffer (rasterizer.render).
        self.raster_visibility = "raycast"
        # Derived state.
        self._plan = None
        self._tri_flags = None
        self._pools_dev = None
        self._n_tris = 0
        self._dynamic: Optional[DynamicMeshState] = None
        self._ptscene: Optional[pt.PTScene] = None
        self._meta: Optional[pt.PTMeta] = None
        self._bvh_host = None
        self._accum = None
        self.accumulated_frames = 0
        self._last_reset_key = None
        self.frame_index = 0
        # Summed [ray_count, nan_count] of the path tracer's samples since
        # the scene was loaded, on the device (read it after the frames).
        self.ray_stats = None
        self.stats: Dict[str, float] = {}
        self.profile = False  # span ms in stats["pass_ms"], stats["counts"]
        self.history = collections.deque(maxlen=240)  # per-frame counter ring
        self._scene_bytes = 0
        # glTF camera tracking: the view follows the camera node's global
        # transform every frame (Gltf.cpp:1015-1041, Camera.h:70-73).
        self._track_camera: Optional[int] = None
        self._track_camera_node: Optional[int] = None

    # -- loading -----------------------------------------------------------

    def _together(self):
        return distributed.together(self._fail_together and self.mesh is not None
                                    and dist.is_initialized())

    def load_scene(self, path_or_scene, scene_id=None):
        """LoadGltf (Main.cpp:43-54) of a path or a loaded T.Scene; scene_id
        selects a glTF scene (the document's default by default)."""
        with self._together():
            return self._load_scene(path_or_scene, scene_id)

    def _load_scene(self, path_or_scene, scene_id):
        scene = path_or_scene if isinstance(path_or_scene, T.Scene) else load_gltf(path_or_scene)
        sid = scene.default_scene if scene_id is None else scene_id
        if scene.scenes and not (0 <= sid < len(scene.scenes)):
            # Validate before any state changes.
            raise IndexError(f"scene index {sid} out of range (document has "
                             f"{len(scene.scenes)} scenes)")
        dev = self.device
        self.scene = scene
        self.scene_id = sid
        plan = flatten.build_instance_plan(scene, sid)
        self._n_tris = int(len(plan.tri_vertex))
        self._tri_flags = {k: torch.as_tensor(v, device=dev)
                           for k, v in flatten.plan_tri_flags(plan, scene.primitives).items()}
        self._plan = pt._to_device(plan, dev)
        self._pools_dev = pt._to_device(scene.pools, dev)
        self._dynamic = DynamicMeshState(scene, dev)
        self._scene_bytes = _host_bytes(scene.pools, scene.materials, scene.textures)
        self._ptscene = None
        self._bvh_host = None
        self._accum = None
        self.accumulated_frames = 0
        self.ray_stats = torch.zeros(2, dtype=torch.float32, device=dev)
        self.player = AnimationPlayer()
        if scene.animations:
            self.player.animation = scene.animations[0]
        return scene

    def select_scene(self, scene_id: int):
        """Re-plan for another glTF scene of the document."""
        self.load_scene(self.scene, scene_id=scene_id)

    def select_animation(self, index: Optional[int]):
        self.player.animation = None if index is None else self.scene.animations[index]
        self.player.time = 0.0

    def select_camera(self, index: Optional[int], viewport_aspect: float = None):
        """Follow glTF camera `index` (None: back to the free / orbit
        camera): its intrinsics, and each frame its node's global transform."""
        self._track_camera = index
        self._track_camera_node = None
        if index is None:
            return
        cam = self.scene.cameras[index]
        self._track_camera_node = next(
            (i for i, nd in enumerate(self.scene.nodes) if nd.camera == index), None)
        self.camera.type = cam.type
        self.camera.y_fov = cam.yfov
        self.camera.aspect_ratio = cam.aspect or (
            viewport_aspect or self.settings.width / self.settings.height)
        self.camera.z_near = cam.znear
        self.camera.z_far = cam.zfar
        self.camera.x_mag = cam.xmag
        self.camera.y_mag = cam.ymag

    def _apply_tracked_camera(self, node_tf):
        if self._track_camera is None or self._track_camera_node is None:
            return
        self.camera.world_to_view = np.linalg.inv(
            np.asarray(node_tf[self._track_camera_node])).astype(np.float32)

    def load_environment(self, path_or_array):
        """An .hdr / .exr file or an (h, w, 3) equirect array as the
        environment (env.environment.build_environment on the renderer's
        device, with the two prefiltered cubes the raster backend samples)."""
        with self._together():
            self._load_environment(path_or_array)

    def _load_environment(self, path_or_array):
        if isinstance(path_or_array, str):
            equirect = read_environment_image(path_or_array)
        else:
            equirect = np.asarray(path_or_array, np.float32)
        self.env = build_environment(equirect, device=self.device)
        self._ptscene = None

    # -- per-frame ---------------------------------------------------------

    def _update_geometry(self, pose: Optional[LocalPose]):
        """Pose the nodes, skin and morph, rebuild the world on the device;
        build the path tracer's tables at the first frame. After it, scenes
        with skinned or morphed meshes refit the tree to the new vertices;
        other scenes swap in the new world and lights and keep the first
        frame's tree, as the JAX renderer does."""
        scene = self.scene
        if pose is None:
            pose = rest_pose(scene)
        node_tf = flatten.compute_global_transforms(scene, None, pose.t, pose.r, pose.s)
        lights = flatten.gather_lights(scene, node_tf)
        has_dynamic = bool(self._dynamic.dynamic_instances)
        dyn = (None, None, None)
        if has_dynamic:
            self._dynamic.update(node_tf, pose.weights)
            dyn = (self._dynamic.positions, self._dynamic.normals, self._dynamic.tangents)
        world = flatten.build_world_geometry(self._pools_dev, self._plan, node_tf,
                                             flatten.normal_transforms(node_tf),
                                             self._tri_flags, *dyn, device=self.device)
        if self._ptscene is None:
            self._ptscene, self._meta = pt.make_pt_scene(world, scene.materials, scene.textures,
                                                         lights, env=self.env,
                                                         device=self.device)
            self._bvh_host = self._ptscene.bvh if has_dynamic else None
        elif has_dynamic:
            self._ptscene = pt.refit_pt_scene(self._ptscene, world, lights, self._bvh_host)
        else:
            self._ptscene = self._ptscene._replace(world=world,
                                                   lights=pt._to_device(lights, self.device))
        return node_tf

    def _reset_key(self):
        """What resets accumulation when it changes (Main.cpp:262-337): the
        settings, the params, the camera, the scene, the environment and the
        animation time. Host values only."""
        param_key = tuple(tuple(np.asarray(v).ravel().tolist()) for v in self.params)
        return (
            self.settings.pt,
            param_key,
            tuple(np.asarray(self.camera.world_to_clip()).ravel().tolist()),
            id(self.scene),
            id(self.env),
            self.player.time if self.player.animation else 0.0,
        )

    def save_state(self, path: str):
        """Checkpoint the progressive accumulation (the JAX renderer's .npz
        keys: accum, accumulated_frames, frame_index). Sharded, rank 0
        writes the file (every rank holds the same state)."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        np.savez(path,
                 accum=self._accum.cpu().numpy() if self._accum is not None else np.zeros(0),
                 accumulated_frames=self.accumulated_frames,
                 frame_index=self.frame_index)

    def load_state(self, path: str):
        """Resume a checkpointed progressive render on the renderer's device
        (camera, scene and settings must match, or the reset key clears it).
        Sharded, every rank reads the file."""
        data = np.load(path)
        accum = data["accum"]
        self._accum = torch.as_tensor(accum, device=self.device) if accum.size else None
        self.accumulated_frames = int(data["accumulated_frames"])
        self.frame_index = int(data["frame_index"])
        self._last_reset_key = self._reset_key()

    def _pt_step(self, c2w, resolution, seed: int):
        """One sample a pixel accumulated into the running mean."""
        dev = self.device
        # A fill, not a copy from the host: no wait for the queued work.
        frames = torch.full((), self.accumulated_frames, dtype=torch.int64, device=dev)
        if self.mesh is None:
            radiance, stats = pt.trace(self._ptscene, self._meta, self.settings.pt, self.params,
                                       c2w, resolution, seed, with_stats=True)
        else:
            radiance, stats = sharding.render_sharded(
                self._ptscene, self._meta, self.settings.pt, self.params, c2w, resolution, seed,
                self.mesh, with_stats=True)
        self.ray_stats = self.ray_stats + stats
        return pt.accumulate(self._accum, radiance, frames, self.settings.pt)

    def draw_frame(self, delta: float = 0.0, seed: Optional[int] = None) -> np.ndarray:
        """One frame -> (h, w, 3) u8 on the host. Progressive accumulation
        persists across calls until the camera, settings or animation change
        (Pathtracer.cpp:259-272)."""
        assert self.scene is not None, "no scene loaded"
        with self._together():
            return self._frame(delta, seed)

    def _frame(self, delta: float, seed: Optional[int]) -> np.ndarray:
        t_frame = time.perf_counter()
        counts_0 = _counts() if self.profile else None
        with spans.frame("draw_frame", record=self.profile) as record:
            img_np = self._draw(delta, seed)
        self.frame_index += 1
        frame_ms = round((time.perf_counter() - t_frame) * 1e3, 3)
        st = self.settings
        self.stats = {
            "frame": self.frame_index,
            "frame_ms": frame_ms,
            "accumulated_frames": self.accumulated_frames,
            "backend": st.backend,
            "triangles": self._n_tris,
            "scene_bytes": self._scene_bytes,
        }
        if record is not None:
            self.stats["pass_ms"] = {k: round(v, 3) for k, v in record.ms.items()}
            k1, hops, chunks, compactions = (b - a for a, b in zip(counts_0, _counts()))
            # The u8 copy has waited for the frame: this read waits for nothing.
            live = 0 if record.live_lanes is None else int(record.live_lanes)
            self.stats["counts"] = {"k1_launches": k1, "alpha_hops": hops,
                                    "alpha_reads": record.alpha_reads, "chunks": chunks,
                                    "compactions": compactions, "live_lanes": live,
                                    "lanes_shaded": record.lanes_shaded}
        if self.mesh is not None:
            self.stats["collective_ms"] = round(self.mesh.collective_ms(), 3)
        self.history.append({
            "frame": self.frame_index,
            "frame_ms": frame_ms,
            "spp": self.accumulated_frames,
            "backend": st.backend,
        })
        return img_np

    def _draw(self, delta: float, seed: Optional[int]) -> np.ndarray:
        st = self.settings
        if self.mesh is not None:
            self.mesh.log.clear()

        def _timed(name, fn, *a, **kw):
            with spans.span(name):
                out = fn(*a, **kw)
                if self.profile:
                    synchronize(self.device)
            return out

        pose = self.player.tick(self.scene, delta) if self.player.animation else None
        node_tf = _timed("skin_and_refit", self._update_geometry, pose)
        self._apply_tracked_camera(node_tf)

        key = self._reset_key()
        if key != self._last_reset_key:
            self._last_reset_key = key
            self.accumulated_frames = 0

        resolution = (st.width, st.height)
        c2w = self.camera.clip_to_world()
        if self._accum is None or tuple(self._accum.shape[:2]) != (st.height, st.width):
            self._accum = torch.zeros((st.height, st.width, 3), dtype=torch.float32,
                                      device=self.device)
            self.accumulated_frames = 0

        if st.backend == "pathtracer":
            if self.accumulated_frames < st.pt.max_accumulated_frames:
                # Pathtracer.cpp:316: the frame counter as the seed, or the
                # pinned seed.
                if seed is not None:
                    frame_seed = seed
                elif st.pt.use_frame_as_seed:
                    frame_seed = self.accumulated_frames
                else:
                    frame_seed = self.params.fixed_seed
                self._accum = _timed("path_trace_scene", self._pt_step, c2w, resolution,
                                     int(frame_seed) & rng.M32)
                self.accumulated_frames += 1
            hdr = self._accum
            bloom_settings = None  # bloom is raster-only (Rasterizer.cpp:281)
        else:
            hdr = _timed("draw_scene", raster_step, self._ptscene, self._meta, st, self.params,
                         c2w, self.camera.position(), resolution, self.frame_index,
                         visibility=self.raster_visibility, mesh=self.mesh)
            self._accum = hdr
            bloom_settings = st.bloom

        img = _timed("post(bloom+tonemap)", post_step, hdr, st.tonemap, bloom_settings,
                     self.frame_index)
        with spans.span("u8_copy"):
            return img.cpu().numpy()  # waits for the frame: frame_ms is wall time

    def capture_trace(self, log_dir: str):
        """A torch.profiler trace of the frames drawn inside the context,
        written to `log_dir` as a Chrome / TensorBoard trace:

            with renderer.capture_trace("traces"):
                renderer.draw_frame()
        """
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
