"""The path tracer's ray chunk (render/pathtracer.py RAY_CHUNK), on the CPU at
48x32.

- A pixel's samples depend on its coordinates and the seed alone, and the
  hop loops run each ray to its own end or bound, so `trace_chunked` in
  chunks of a few hundred rays gives the image and the [ray_count,
  nan_count] stats of one chunk covering the call, bit for bit: on the
  alpha-MASKed foliage scene (retry and alpha-shadow hop loops on) at
  1 spp, on the opaque textured sphere at 2 spp, and on a tile placed in its
  image with `pixel_offset` / `full_resolution`, as `render_sharded` draws it.
- RAY_CHUNK holds a whole 1080p frame at 1 spp, and RAY_CHUNKS counts the
  `_trace_rays` calls: 1 for a small frame, ceil(rays / chunk) at a smaller
  chunk; the Renderer reports a frame's as `stats["counts"]["chunks"]`.
- The raster backend keeps its own 262,144-ray slices (RASTER_CHUNK).
"""

import math

import pytest
import torch

from gltf_renderer_tpu_torch.camera import look_at
from gltf_renderer_tpu_torch.render import pathtracer as pt
from gltf_renderer_tpu_torch.render import rasterizer as rz
from gltf_renderer_tpu_torch.render import settings as S
from gltf_renderer_tpu_torch.render.renderer import Renderer
from gltf_renderer_tpu_torch.scene.procedural import foliage_scene, textured_sphere_scene

torch.set_num_threads(2)
W, H = 48, 32
SMALL_CHUNK = 256
SCENES = {"masked": foliage_scene, "opaque": textured_sphere_scene}


def _renderer(kind):
    r = Renderer(S.RenderSettings(width=W, height=H, pt=S.PathTracerSettings(
        max_bounces=2, min_bounces=1, alpha_shadows=True)), device="cpu")
    r.load_scene(SCENES[kind]())
    r.camera.aspect_ratio = W / H
    r.camera.z_near = 0.01
    r.camera.world_to_view = look_at([0.0, -4.0, 1.0], [0.0, 0.0, -0.5])
    r.draw_frame()  # builds the tables
    return r


@pytest.fixture(scope="module")
def renderers():
    return {kind: _renderer(kind) for kind in SCENES}


def _trace(r, chunk, spp, tile):
    """(image, stats, _trace_rays calls, alpha hops) of one trace_chunked call."""
    if tile:
        res, place = (W, H // 2), dict(pixel_offset=(0, H // 2), full_resolution=(W, H))
    else:
        res, place = (W, H), {}
    calls_0, hops_0 = pt.RAY_CHUNKS, pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS
    img, st = pt.trace_chunked(r._ptscene, r._meta, r.settings.pt, r.params,
                               r.camera.clip_to_world(), res, 0xFFFFFFF0, with_stats=True,
                               chunk=chunk, spp=spp, **place)
    return (img, st, pt.RAY_CHUNKS - calls_0,
            pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS - hops_0)


@pytest.mark.parametrize("kind, spp, tile", [("masked", 1, False), ("opaque", 2, False),
                                             ("masked", 1, True)],
                         ids=["masked_spp1", "opaque_spp2", "masked_tile"])
def test_many_chunks_equal_one(renderers, kind, spp, tile):
    r = renderers[kind]
    h = H // 2 if tile else H
    rays = pt._tile_order(W, h, torch.device("cpu"))[0].shape[0] * spp
    one = _trace(r, rays, spp, tile)
    many = _trace(r, SMALL_CHUNK, spp, tile)
    assert one[2] == 1 and many[2] == math.ceil(rays / SMALL_CHUNK) > 1
    assert torch.equal(one[0], many[0]) and torch.isfinite(one[0]).all()
    assert torch.equal(one[1], many[1]) and float(one[1][0]) >= W * h * spp
    if kind == "masked":
        assert 0 < one[3] <= many[3]  # the hop loops ran, once over the whole call


def test_a_1080p_frame_is_one_chunk():
    assert pt._tile_order(1920, 1080, torch.device("cpu"))[0].shape[0] <= pt.RAY_CHUNK
    assert pt.RAY_CHUNK % 4 == 0  # a 1080p frame at spp 4 cuts into whole chunks


@pytest.mark.parametrize("chunk", [None, 96])
def test_ray_chunks_counts_trace_rays_calls(renderers, chunk):
    r = renderers["opaque"]
    res = (16, 16)
    calls_0 = pt.RAY_CHUNKS
    kw = {} if chunk is None else {"chunk": chunk}
    pt.trace(r._ptscene, r._meta, r.settings.pt, r.params, r.camera.clip_to_world(), res, 3,
             **kw)
    rays = pt._tile_order(*res, torch.device("cpu"))[0].shape[0]
    assert pt.RAY_CHUNKS - calls_0 == (1 if chunk is None else math.ceil(rays / chunk)) > 0


def test_renderer_counts_a_frames_chunks(renderers):
    r = renderers["masked"]
    r.profile = True
    try:
        r.draw_frame()
    finally:
        r.profile = False
    assert r.stats["counts"]["chunks"] == 1


def test_raster_keeps_its_own_chunk():
    assert rz.RASTER_CHUNK == 262144
    assert not hasattr(rz, "RAY_CHUNK")  # the raster slices do not follow the path tracer's
