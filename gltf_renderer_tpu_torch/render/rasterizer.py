"""Raster backend: the opaque pass of Rasterizer::DrawScene.

Port of gltf_renderer_tpu/render/rasterizer.py (Rasterizer.cpp +
ForwardPass.cpp + Forward.vs/ps). Primary visibility is either

- "raycast": pixel rays against the scene BVH through ops.traverse (the
  CUDA traversal kernel on the card), which for opaque geometry gives the
  same closest surface per pixel as a z-buffer, or
- "tiled": the tile-binned rasterizer of ops.raster (the CUDA
  tile-rasterizer kernel on the card), with near-plane clipping.

Shading is Forward.ps.hlsl: forward PBR with image-based lighting from the
GGX-prefiltered and diffuse-convolved cubes with the Pesce/Iwanicki DFG
bias-scale approximation (Forward.ps.hlsl:203-264) and the anisotropic bent
normal, textures sampled trilinearly from the scene's mip pyramid at the
ray-differential footprint; missed pixels show the environment
(Background.ps.hlsl). Pixels stream through RAY_CHUNK-sized slices in the
path tracer's 32x32 tile order.

Not ported yet (scenes or arguments that need them raise
NotImplementedError): the blend / transmission pass and its backdrop mips,
clearcoat IBL, punctual lights, the alpha-masked retry and motion vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from gltf_renderer_tpu_torch import camera
from gltf_renderer_tpu_torch.env.environment import env_radiance, sample_cube
from gltf_renderer_tpu_torch.ops import bvh as bvh_ops
from gltf_renderer_tpu_torch.ops import raster
from gltf_renderer_tpu_torch.ops.material import get_surface_properties
from gltf_renderer_tpu_torch.render.pathtracer import (
    RAY_CHUNK,
    Hit,
    PTMeta,
    PTScene,
    _from_tile_order,
    _tile_order,
    _to_tile_order,
    closest_hit,
    fetch_hit_attributes,
    generate_camera_rays,
)
from gltf_renderer_tpu_torch.utils.math import cross, dot, normalize, reflect, saturate, sum_last

VISIBILITIES = ("raycast", "tiled")


def check_raster_supported(meta: PTMeta) -> None:
    """Raise NotImplementedError for what the opaque pass cannot draw."""
    missing = [name for name in ("has_blend", "has_masked", "has_clearcoat")
               if getattr(meta, name)]
    if meta.num_lights > 0:
        missing.append("punctual lights")
    if missing:
        raise NotImplementedError(f"the torch raster backend does not support {missing} yet")


def shade_forward(scene: PTScene, meta: PTMeta, hit: Hit, direction, env_intensity,
                  use_env: bool = True, mip_scale=None):
    """Forward.ps.hlsl main for opaque hits. Returns (rgb, base alpha,
    alpha cutoff, alpha mode).

    mip_scale: (R,) world-space footprint of the pixel at the hit; with a
    scene mip pyramid the textures are sampled trilinearly at the
    footprint's level (None samples level 0)."""
    check_raster_supported(meta)
    use_mips = mip_scale is not None and scene.textures.mip_flat is not None
    attrs = fetch_hit_attributes(scene.world, hit.tri, hit.u, hit.v, direction,
                                 with_footprint=use_mips, raster_flip=True)
    mip_base = None
    if use_mips:
        cos_i = torch.abs(dot(attrs.geometric_normal, direction, keepdims=False))
        fp = mip_scale * attrs.uv_area_ratio / torch.sqrt(torch.clamp(cos_i, min=1e-2))
        mip_base = torch.log2(torch.clamp(fp, min=1e-20))
    view = -direction
    sp, extras = get_surface_properties(
        scene.materials, scene.textures, attrs.material, attrs.uv0, attrs.uv1, attrs.color,
        attrs.normal, attrs.tangent, attrs.bitangent, attrs.geometric_normal, view,
        use_geometric_normals=False, shading_normal_adaptation=False,
        used_slots=meta.used_slots, identity_uv=meta.identity_uv, wrap_modes=meta.wrap_modes,
        any_nearest=meta.any_nearest, mip_base=mip_base)
    lighting = extras.emissive

    if use_env and meta.has_env:
        ggx_mips = scene.env.ggx
        n_mips = len(ggx_mips)
        rough2_t, rough2 = sp.roughness_squared[..., 0], sp.roughness_squared[..., 1]
        rough = torch.sqrt(rough2)
        mip = torch.clamp(rough * (n_mips - 1), 0.0, n_mips - 1)

        # Anisotropic bent normal (Forward.ps.hlsl:214-222).
        a_strength = torch.sqrt(torch.clamp(
            (rough2_t - rough2) / torch.clamp(1.0 - rough2, min=1e-6), 0.0, 1.0))
        an_tangent = cross(sp.anisotropy_bitangent, view)
        an_normal = cross(an_tangent, sp.anisotropy_bitangent)
        bend = 1.0 - a_strength * (1.0 - rough)
        bend = bend * bend
        bend = bend * bend
        bent_normal = normalize(an_normal + bend[..., None] * (sp.shading_normal - an_normal))

        ld = env_intensity * sample_cube(ggx_mips, reflect(-view, bent_normal), mip)
        n_dot_v = saturate(dot(sp.shading_normal, view, keepdims=False))
        a2 = rough2 * rough2
        # Pesce/Iwanicki DFG bias-scale (Forward.ps.hlsl:235-237).
        bias = torch.pow(2.0, -(7.0 * n_dot_v + 4.0 * a2))
        scale = 1.0 - bias - a2 * torch.maximum(
            bias, torch.minimum(rough2, 0.739 + 0.323 * n_dot_v) - 0.434)
        f0 = (1.0 - sp.ior) / (1.0 + sp.ior)
        f0 = torch.clamp(f0 * f0 * sp.specular_color, max=1.0)
        dfg = (f0 * scale[..., None] + bias[..., None]) * sp.specular_factor
        specular_ibl = dfg * ld
        diffuse_ibl = ((1.0 - dfg) * sp.albedo * env_intensity
                       * sample_cube([scene.env.diffuse], sp.shading_normal,
                                     torch.zeros_like(rough2)))
        dielectric_ibl = diffuse_ibl + specular_ibl
        metal_ibl = (sp.albedo * scale[..., None] + bias[..., None]) * ld
        ibl = dielectric_ibl + sp.metalness * (metal_ibl - dielectric_ibl)
        lighting = lighting + ibl * extras.occlusion[..., None]

    return lighting, extras.base_color[..., 3], extras.alpha_cutoff, extras.alpha_mode


def _pixel_rays(cpx, cpy, resolution, clip_to_world):
    w, h = resolution
    zero_jitter = torch.zeros(cpx.shape + (2,), dtype=torch.float32, device=cpx.device)
    origin, dir_raw = generate_camera_rays(cpx, cpy, (w, h), clip_to_world, zero_jitter)
    ray_len = torch.sqrt(torch.clamp(sum_last(dir_raw * dir_raw), min=1e-20))
    direction = dir_raw / ray_len[..., None]
    return origin, direction, ray_len


def _pixel_spread(clip_to_world, resolution):
    """Angular spread of one pixel in far-plane units: camera rays are
    affine in pixel coordinates, so at a hit the world footprint is
    t * s0 / |raw ray|."""
    dev = clip_to_world.device
    _, raw3 = generate_camera_rays(
        torch.tensor([0, 1, 0], dtype=torch.int32, device=dev),
        torch.tensor([0, 0, 1], dtype=torch.int32, device=dev),
        resolution, clip_to_world, torch.zeros((3, 2), dtype=torch.float32, device=dev))

    def norm(x):
        return torch.sqrt(sum_last(x * x))

    return torch.sqrt(norm(raw3[1] - raw3[0]) * norm(raw3[2] - raw3[0]))


def _tiled_visibility(scene: PTScene, clip_to_world_np, w: int, h: int):
    """(tri, u, v) streams in tile order from the tile rasterizer. The JAX
    package drops blended / transmissive triangles from this opaque buffer
    (rasterizer.py:496-503); scenes holding any are refused here
    (check_raster_supported), so there is none to drop."""
    world = scene.world
    _, tri_b, u_b, v_b = raster.rasterize_device(
        world.position, world.tri_vertex, camera.world_to_clip(clip_to_world_np), w, h,
        double_sided=world.tri_double_sided)
    return (_to_tile_order(tri_b).to(torch.int64), _to_tile_order(u_b), _to_tile_order(v_b))


def render(scene: PTScene, meta: PTMeta, render_settings, params, clip_to_world, camera_pos,
           resolution, frame, visibility: str = "raycast"):
    """Rasterizer::DrawScene's opaque pass -> (h, w, 3) HDR linear image.

    clip_to_world (4, 4) host matrix; camera_pos and frame are taken for
    the reference's signature (the opaque pass reads neither)."""
    if visibility not in VISIBILITIES:
        raise ValueError(f"visibility must be one of {VISIBILITIES}, got {visibility!r}")
    check_raster_supported(meta)
    w, h = resolution
    dev = scene.world.position.device
    c2w_np = np.asarray(clip_to_world, np.float32)
    c2w = torch.as_tensor(c2w_np, device=dev)
    px, py, _ = _tile_order(w, h, dev)
    n = px.shape[0]
    env_intensity = params.environment_intensity
    use_env = meta.has_env
    has_mips = scene.textures.mip_flat is not None
    s0 = _pixel_spread(c2w, (w, h)) if has_mips else None
    tiled = _tiled_visibility(scene, c2w_np, w, h) if visibility == "tiled" else None

    lit = []
    for start in range(0, n, RAY_CHUNK):
        sl = slice(start, start + RAY_CHUNK)
        origin, direction, t_max = _pixel_rays(px[sl], py[sl], (w, h), c2w)
        if tiled is not None:
            ctri, cu, cv = (x[sl] for x in tiled)
            row = scene.world.tri_attr_rows[torch.clamp(ctri, min=0)]
            wpos = ((1.0 - cu - cv)[:, None] * row[:, 0:3] + cu[:, None] * row[:, 20:23]
                    + cv[:, None] * row[:, 40:43])
            d = wpos - origin
            dist = torch.sqrt(sum_last(d * d))
            hit = Hit(t=torch.where(ctri >= 0, dist, t_max), tri=ctri, u=cu, v=cv)
        else:
            hit = closest_hit(scene, meta, origin, direction, torch.zeros_like(t_max), t_max,
                              blend_mode=bvh_ops.BLEND_EXCLUDE)
        mip_scale = (torch.clamp(hit.t, min=0.0) * s0 / torch.clamp(t_max, min=1e-20)
                     if has_mips else None)
        rgb, _, _, _ = shade_forward(scene, meta, hit, direction, env_intensity,
                                     use_env=use_env, mip_scale=mip_scale)
        if use_env:
            bg = env_intensity * env_radiance(scene.env, normalize(direction))
        else:
            # No environment: the reference rasterizer clears to black
            # (Rasterizer.cpp:183, :222-229).
            bg = torch.zeros_like(rgb)
        lit.append(torch.where((hit.tri >= 0)[..., None], rgb, bg))
    return _from_tile_order(torch.cat(lit), w, h)
