"""One raster frame: draw, then post.

Counterparts of `_raster_step` and `_post_step` in
gltf_renderer_tpu/render/renderer.py (Renderer::DrawFrame's raster branch,
Renderer.cpp:274-374). The `Renderer` class around them is not ported yet.
"""

from __future__ import annotations

from gltf_renderer_tpu_torch.post.bloom import bloom as bloom_op
from gltf_renderer_tpu_torch.post.tonemap import to_u8, tonemap
from gltf_renderer_tpu_torch.render import rasterizer
from gltf_renderer_tpu_torch.render import settings as S


def raster_step(scene, meta, settings: S.RenderSettings, params, c2w, cam_pos, resolution,
                frame, visibility: str = "raycast"):
    """DrawScene -> (h, w, 3) HDR linear image on the scene's device: the
    opaque and alpha-tested pass, the background, and the blended and
    transmissive layers over the backdrop pyramid."""
    return rasterizer.render(scene, meta, settings, params, c2w, cam_pos, resolution, frame,
                             visibility=visibility)


def post_step(hdr, tonemap_settings: S.ToneMapSettings, bloom_settings, frame):
    """Bloom (when enabled) + tone map + dither -> (h, w, 3) uint8."""
    img = hdr
    if bloom_settings is not None and bloom_settings.enabled:
        img = bloom_op(hdr, bloom_settings.max_mips, bloom_settings.strength)
    return to_u8(tonemap(img, tonemap_settings.tonemapper, tonemap_settings.exposure, frame))
