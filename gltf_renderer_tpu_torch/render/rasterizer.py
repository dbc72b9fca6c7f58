"""Raster backend: Rasterizer::DrawScene.

Port of gltf_renderer_tpu/render/rasterizer.py (Rasterizer.cpp +
ForwardPass.cpp + Forward.vs/ps). Primary visibility is either

- "raycast": pixel rays against the scene BVH through ops.traverse (the
  CUDA traversal kernel on the card), which for opaque geometry gives the
  same closest surface per pixel as a z-buffer, or
- "tiled": the tile-binned rasterizer of ops.raster (the CUDA
  tile-rasterizer kernel on the card), with near-plane clipping; blended
  and transmissive triangles are dropped from its opaque buffer.

Pass order is the reference's: opaque + alpha test (alpha-MASKed texels
below the cutoff are re-traced past, `_alpha_retry_raster`) -> background
-> the transmission backdrop pyramid of the lit image -> up to
MAX_BLEND_LAYERS blended / transmissive layers a pixel, collected front to
back along the pixel ray and composited back to front. Shading is
Forward.ps.hlsl: IBL from the GGX-prefiltered and diffuse-convolved cubes
with the Pesce/Iwanicki DFG bias-scale approximation and the anisotropic
bent normal, screen-space transmission through the blurred backdrop,
clearcoat IBL, and the punctual lights through the full layered BSDF (no
shadows, as the reference rasterizer); textures are sampled trilinearly
from the scene's mip pyramid at the ray-differential footprint; missed
pixels show the environment (Background.ps.hlsl). Motion vectors come from
the previous frame's world-to-clip. Pixels stream through RASTER_CHUNK-sized
slices in the path tracer's 32x32 tile order.

The masked retry stops when no lane is left to retry, read as one scalar
on the host per hop, or at MAX_ALPHA_HOPS; RASTER_RETRY_HOPS counts the
hops it runs, each one more traverse_wide launch.

`render` also draws one tile of a larger image (pixel_offset,
full_resolution), as the sharded frame of parallel.sharding does: pixel
rays, the pixel footprint, screen uv and motion vectors read absolute
pixels of the full image, and `lit_gather` assembles the full lit image
from which the transmission backdrop is built. Tiles need the raycast
visibility.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gltf_renderer_tpu_torch import camera
from gltf_renderer_tpu_torch.env.environment import env_radiance, sample_cube
from gltf_renderer_tpu_torch.ops import bvh as bvh_ops
from gltf_renderer_tpu_torch.ops import raster
from gltf_renderer_tpu_torch.ops.bsdf import fresnel_coat, gltf_bsdf, modulate_roughness
from gltf_renderer_tpu_torch.ops.lights import get_light_ray
from gltf_renderer_tpu_torch.ops.material import get_surface_properties
from gltf_renderer_tpu_torch.post.bloom import downsample
from gltf_renderer_tpu_torch.render.pathtracer import (
    MAX_ALPHA_HOPS,
    Hit,
    PTMeta,
    PTScene,
    _from_tile_order,
    _needs_alpha_retry,
    _tile_order,
    _to_tile_order,
    closest_hit,
    fetch_hit_attributes,
    generate_camera_rays,
)
from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.utils import spans
from gltf_renderer_tpu_torch.utils.math import (
    cross,
    dot,
    normalize,
    reflect,
    saturate,
    sum_last,
    trunc_i32,
)

VISIBILITIES = ("raycast", "tiled")
MAX_BLEND_LAYERS = 4  # depth-sorted transparent layers composited per pixel
# Pixel rays per slice of the opaque and blend passes: a memory bound on the
# hit lists the passes keep for blending and motion, set apart from the path
# tracer's RAY_CHUNK.
RASTER_CHUNK = 262144

RASTER_RETRY_HOPS = 0  # hops run by the raster masked retry


@functools.lru_cache(maxsize=1)
def _jimenez_conv_kernel():
    """The 13-tap kernel at the exact 2x ratio as one 6x6 stride-2 stencil:
    every tap lands on a texel pair, so each bilinear tap is a 2x2 box at a
    fixed integer shift.

    The tap weights are the reference shader's pattern-2 source with its
    copy-paste quirk (TransmissionDownsample.cs.hlsl:45-56): the (+x, -y)
    taps appear twice in both diagonal rings and the (-x, -y) taps are
    missing, so the kernel leans toward +x, -y. +y in uv is +row."""
    taps = [((0, 0), 0.125)]
    # Inner diagonal ring, shader order: (x,y), (x,-y), (-x,y), (x,-y) again.
    taps += [((1, 1), 0.125), ((-1, 1), 0.25), ((1, -1), 0.125)]
    taps += [((0, -2), 0.0625), ((0, 2), 0.0625), ((-2, 0), 0.0625), ((2, 0), 0.0625)]
    # Outer diagonal ring, the same duplication: (2x,2y), (2x,-2y) twice, (-2x,2y).
    taps += [((2, 2), 0.03125), ((-2, 2), 0.0625), ((2, -2), 0.03125)]
    k = np.zeros((6, 6), np.float32)
    for (sy, sx), w in taps:
        for a in (0, 1):
            for b in (0, 1):
                k[2 + sy + a, 2 + sx + b] += w * 0.25
    return k


def _jimenez_13tap(img, out_h, out_w):
    """CoD: AW 13-tap downsample (TransmissionDownsample.cs.hlsl kernel 2)
    of channel-last (H, W, C): one stride-2 depthwise convolution of the
    edge-padded crop to (2 out_h, 2 out_w). A side too short for the 6x6
    stencil gives an empty mip, as the reference's convolution does."""
    crop = img[: 2 * out_h, : 2 * out_w].permute(2, 0, 1).unsqueeze(1)
    pad = F.pad(crop, (2, 2, 2, 2), mode="replicate")
    n_h, n_w = (pad.shape[-2] - 6) // 2 + 1, (pad.shape[-1] - 6) // 2 + 1
    if n_h <= 0 or n_w <= 0:
        return img.new_zeros((max(n_h, 0), max(n_w, 0), img.shape[-1]))
    k = torch.as_tensor(_jimenez_conv_kernel(), device=img.device)[None, None]
    return F.conv2d(pad, k, stride=2)[:, 0].permute(1, 2, 0)


def build_transmission_mips(lit, n_mips: int = None, kernel: int = 1):
    """ForwardPass::GenerateTransmissionMips: the backdrop blur pyramid of
    the lit (H, W, 3) image, a list of channel-last levels.

    kernel: 0 the shader's default case (one linear sample at the output
    texel centre, a 2x2 box at the exact 2x ratio), 1 the Bjorge dual-filter
    5-tap (`post.bloom.downsample`), 2 the CoD Jimenez 13-tap with the
    reference's tap quirk. n_mips defaults to the full chain,
    floor(log2(max side)) + 1 levels: the reference creates the texture
    with every mip (Rasterizer.cpp:63) and maps roughness over all of them
    (Forward.ps.hlsl:254)."""
    if n_mips is None:
        n_mips = int(np.floor(np.log2(max(lit.shape[0], lit.shape[1], 1)))) + 1
    mips = [lit]
    cur = lit
    for _ in range(n_mips - 1):
        h, w = max(cur.shape[0] // 2, 1), max(cur.shape[1] // 2, 1)
        if kernel == 0:
            c2 = cur[: h * 2, : w * 2]
            cur = 0.25 * (c2[0::2, 0::2] + c2[1::2, 0::2] + c2[0::2, 1::2] + c2[1::2, 1::2])
        elif kernel == 2:
            cur = _jimenez_13tap(cur, h, w)
        else:
            cur = downsample(cur, h, w)
        mips.append(cur)
    return mips


def _backdrop(mips, t_mip, screen_uv):
    """Trilinear sample of the backdrop pyramid at screen uv and fractional
    level t_mip: one 8-corner gather over the flattened levels."""
    dev = t_mip.device
    n = len(mips)
    hs = [m.shape[0] for m in mips]
    ws = [m.shape[1] for m in mips]
    offs = [int(o) for o in np.cumsum([0] + [hh * ww for hh, ww in zip(hs, ws)][:-1])]
    flat = torch.cat([m.reshape(-1, 3) for m in mips])
    hs_t, ws_t, offs_t = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                          for x in (hs, ws, offs))
    l0 = torch.clamp(trunc_i32(torch.floor(t_mip)), 0, n - 1)
    l1 = torch.clamp(l0 + 1, max=n - 1)
    frac = torch.clamp(t_mip - l0.to(torch.float32), 0.0, 1.0).unsqueeze(-1)

    def corner_ids(li):
        li = li.long()
        hh, ww, off = hs_t[li], ws_t[li], offs_t[li]
        fx = screen_uv[..., 0] * ww.to(torch.float32) - 0.5
        fy = screen_uv[..., 1] * hh.to(torch.float32) - 0.5
        x0 = trunc_i32(torch.floor(fx))
        y0 = trunc_i32(torch.floor(fy))
        tx = (fx - x0.to(torch.float32)).unsqueeze(-1)
        ty = (fy - y0.to(torch.float32)).unsqueeze(-1)

        def fi(xi, yi):
            return (off + torch.minimum(torch.clamp(yi, min=0), hh - 1) * ww
                    + torch.minimum(torch.clamp(xi, min=0), ww - 1))

        return torch.stack([fi(x0, y0), fi(x0 + 1, y0), fi(x0, y0 + 1),
                            fi(x0 + 1, y0 + 1)]), tx, ty

    ids0, tx0, ty0 = corner_ids(l0)
    ids1, tx1, ty1 = corner_ids(l1)
    ids = torch.cat([ids0, ids1])
    c = flat[ids.reshape(-1).long()].reshape(ids.shape + (3,))

    def lerp(cs, tx, ty):
        return (cs[0] * (1 - tx) + cs[1] * tx) * (1 - ty) + (cs[2] * (1 - tx) + cs[3] * tx) * ty

    return lerp(c[0:4], tx0, ty0) * (1 - frac) + lerp(c[4:8], tx1, ty1) * frac


def shade_forward(scene: PTScene, meta: PTMeta, hit: Hit, origin, direction, camera_pos,
                  env_intensity, screen_uv, transmission_mips=None, use_env: bool = True,
                  use_lights: bool = True, mip_scale=None):
    """Forward.ps.hlsl main. Returns (rgb, base alpha, alpha cutoff, alpha
    mode).

    origin and camera_pos are taken for the reference's signature; the
    shading reads neither. screen_uv (R, 2) places the transmission
    backdrop's sample (read only with transmission_mips). mip_scale: (R,)
    world-space footprint of the pixel at the hit; with a scene mip pyramid
    the textures are sampled trilinearly at the footprint's level (None
    samples level 0)."""
    use_mips = mip_scale is not None and scene.textures.mip_flat is not None
    # The JAX call also passes ray_origin / ray_t, which act only on bf16
    # attribute rows, a TPU layout the port does not carry.
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

        if transmission_mips is not None and meta.has_transmission:
            t_a = modulate_roughness(sp.roughness_squared[..., 1:2], sp.ior)[..., 0]
            t_mip = torch.sqrt(t_a) * (len(transmission_mips) - 1)
            transmission_ibl = sp.albedo * _backdrop(transmission_mips, t_mip, screen_uv)
            diffuse_ibl = diffuse_ibl + sp.transmissive * (transmission_ibl - diffuse_ibl)

        dielectric_ibl = diffuse_ibl + specular_ibl
        metal_ibl = (sp.albedo * scale[..., None] + bias[..., None]) * ld
        ibl = dielectric_ibl + sp.metalness * (metal_ibl - dielectric_ibl)

        # Clearcoat IBL (Forward.ps.hlsl:266-275), skipped where no material
        # of the scene has a coat.
        if meta.has_clearcoat:
            cc_mip = torch.clamp(sp.clearcoat_roughness[..., 0] * (n_mips - 1), 0.0, n_mips - 1)
            cc_ld = env_intensity * sample_cube(
                ggx_mips, reflect(-view, sp.clearcoat_normal), cc_mip)
            ibl = fresnel_coat(1.5, sp.clearcoat, ibl, cc_ld, dot(sp.clearcoat_normal, view))

        lighting = lighting + ibl * extras.occlusion[..., None]

    if use_lights and meta.num_lights > 0:
        for i in range(meta.num_lights):
            idx = torch.full(hit.tri.shape, i, dtype=torch.int32, device=hit.tri.device)
            ray = get_light_ray(scene.lights, idx, attrs.position)
            f = gltf_bsdf(sp, view, ray.direction, sheen_table=scene.sheen_table)
            lighting = lighting + f * ray.color

    return lighting, extras.base_color[..., 3], extras.alpha_cutoff, extras.alpha_mode


def motion_vectors(world, hit: Hit, px, py, prev_world_to_clip, prev_position=None,
                   resolution=(0, 0)):
    """Per-pixel motion vectors (Forward.ps.hlsl:81-90): the previous
    frame's framebuffer position of the hit minus the pixel centre, in
    pixels; 0 where nothing was hit. prev_world_to_clip (4, 4) tensor;
    prev_position: optional (VW, 3) previous world positions (skinned or
    animated geometry), the current ones by default."""
    w, h = resolution
    trow = world.tri_rows[torch.clamp(hit.tri, min=0).long()].long()
    pos_src = world.position if prev_position is None else prev_position
    w0 = (1.0 - hit.u - hit.v)[..., None]
    prev_pos = (w0 * pos_src[trow[:, 0]] + hit.u[..., None] * pos_src[trow[:, 1]]
                + hit.v[..., None] * pos_src[trow[:, 2]])
    p = torch.cat([prev_pos, torch.ones_like(prev_pos[:, :1])], -1)
    clip = sum_last(p[:, None, :] * prev_world_to_clip[None])
    cw = clip[:, 3:4]
    ndc = clip[:, :3] / torch.where(torch.abs(cw) > 1e-8, cw, torch.full_like(cw, 1e-8))
    fb_x = (ndc[:, 0] + 1.0) * 0.5 * w
    fb_y = (-ndc[:, 1] + 1.0) * 0.5 * h
    mv = torch.stack([fb_x - (px.to(torch.float32) + 0.5), fb_y - (py.to(torch.float32) + 0.5)],
                     -1)
    return torch.where((hit.tri >= 0)[:, None], mv, torch.zeros_like(mv))


def _pixel_rays(cpx, cpy, resolution, clip_to_world, with_screen_uv: bool = False):
    """(origin, unit direction, ray length) of the pixel centres, and their
    screen uv when asked for."""
    w, h = resolution
    zero_jitter = torch.zeros(cpx.shape + (2,), dtype=torch.float32, device=cpx.device)
    origin, dir_raw = generate_camera_rays(cpx, cpy, (w, h), clip_to_world, zero_jitter)
    ray_len = torch.sqrt(torch.clamp(sum_last(dir_raw * dir_raw), min=1e-20))
    direction = dir_raw / ray_len[..., None]
    if not with_screen_uv:
        return origin, direction, ray_len
    screen_uv = torch.stack([(cpx.to(torch.float32) + 0.5) / w,
                             (cpy.to(torch.float32) + 0.5) / h], -1)
    return origin, direction, ray_len, screen_uv


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


def _alpha_retry_raster(scene: PTScene, meta: PTMeta, hit: Hit, origin, direction, t_max) -> Hit:
    """The raster 'discard': lanes whose hit is an alpha-MASKed texel below
    the cutoff trace on from just past it (opaque triangles only), at most
    MAX_ALPHA_HOPS times. Lanes that are done keep their hit and trace an
    empty interval."""
    global RASTER_RETRY_HOPS
    need = _needs_alpha_retry(scene, meta, hit)
    for _ in range(MAX_ALPHA_HOPS):
        if not spans.host_read(need):
            break
        RASTER_RETRY_HOPS += 1
        tmin = torch.where(need, hit.t * (1.0 + 1e-5) + 1e-6, t_max + 1.0)
        nh = closest_hit(scene, meta, origin, direction, tmin, t_max,
                         blend_mode=bvh_ops.BLEND_EXCLUDE)
        hit = Hit(*(torch.where(need, n, c) for n, c in zip(nh, hit)))
        need = _needs_alpha_retry(scene, meta, hit) & need
    return hit


def _tiled_visibility(scene: PTScene, meta: PTMeta, clip_to_world_np, w: int, h: int):
    """(tri, u, v) streams in tile order from the tile rasterizer, blended
    and transmissive triangles dropped from this opaque buffer (a MASK
    material stays opaque, Rasterizer.cpp:106-113)."""
    world = scene.world
    _, tri_b, u_b, v_b = raster.rasterize_device(
        world.position, world.tri_vertex, camera.world_to_clip(clip_to_world_np), w, h,
        double_sided=world.tri_double_sided)
    tri = _to_tile_order(tri_b).to(torch.int64)
    if meta.has_blend:
        tri_c = torch.clamp(tri, min=0)
        am = world.tri_alpha_mode[tri_c]
        transmissive = torch.as_tensor(
            np.asarray(scene.materials.transmission_factor) > 0.0,
            device=tri.device)[world.tri_material[tri_c].long()]
        is_blend = (am == T.ALPHA_MODE_BLEND) | (transmissive & (am != T.ALPHA_MODE_MASK))
        tri = torch.where((tri >= 0) & ~is_blend, tri, torch.full_like(tri, -1))
    return tri, _to_tile_order(u_b), _to_tile_order(v_b)


def render(scene: PTScene, meta: PTMeta, render_settings, params, clip_to_world, camera_pos,
           resolution, frame, prev_world_to_clip=None, prev_position=None,
           with_motion: bool = False, visibility: str = "raycast", pixel_offset=(0, 0),
           full_resolution=None, lit_gather=None):
    """Rasterizer::DrawScene -> (h, w, 3) HDR linear image, and with
    with_motion the (h, w, 2) motion vectors too.

    clip_to_world (4, 4) host matrix; prev_world_to_clip (4, 4) matrix of
    the previous frame (this frame's f32 inverse by default); prev_position
    (VW, 3) previous world positions on the scene's device. render_settings
    and frame are taken for the reference's signature (the draw reads
    neither).

    A tile of a larger image: `resolution` is the tile's (w, h),
    `pixel_offset` the image pixel of its (0, 0), `full_resolution` the
    image's (w, h), and `lit_gather` maps the tile's (h, w, 3) lit image
    to the full image's, from which the transmission backdrop is built
    (the blend pass samples it at absolute screen uv)."""
    if visibility not in VISIBILITIES:
        raise ValueError(f"visibility must be one of {VISIBILITIES}, got {visibility!r}")
    if full_resolution is not None and visibility != "raycast":
        raise ValueError("a tile of a larger image needs the raycast visibility")
    w, h = resolution
    fw, fh = resolution if full_resolution is None else full_resolution
    dev = scene.world.position.device
    c2w_np = np.asarray(clip_to_world, np.float32)
    c2w = torch.as_tensor(c2w_np, device=dev)
    px, py, _ = _tile_order(w, h, dev)
    px = px + int(pixel_offset[0])
    py = py + int(pixel_offset[1])
    n = px.shape[0]
    env_intensity = params.environment_intensity
    use_env = meta.has_env
    has_mips = scene.textures.mip_flat is not None
    s0 = _pixel_spread(c2w, (fw, fh)) if has_mips else None
    tiled = _tiled_visibility(scene, meta, c2w_np, w, h) if visibility == "tiled" else None
    keep_hits = meta.has_blend or with_motion

    # Opaque + alpha-test + background pass.
    lit, opaque = [], []
    for start in range(0, n, RASTER_CHUNK):
        sl = slice(start, start + RASTER_CHUNK)
        origin, direction, t_max = _pixel_rays(px[sl], py[sl], (fw, fh), c2w)
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
        if meta.has_masked:
            hit = _alpha_retry_raster(scene, meta, hit, origin, direction, t_max)
        valid = hit.tri >= 0
        mip_scale = (torch.clamp(hit.t, min=0.0) * s0 / torch.clamp(t_max, min=1e-20)
                     if has_mips else None)
        rgb, _, _, _ = shade_forward(scene, meta, hit, origin, direction, camera_pos,
                                     env_intensity, None, use_env=use_env, mip_scale=mip_scale)
        if use_env:
            bg = env_intensity * env_radiance(scene.env, normalize(direction))
        else:
            # No environment: the reference rasterizer clears to black
            # (Rasterizer.cpp:183, :222-229).
            bg = torch.zeros_like(rgb)
        lit.append(torch.where(valid[..., None], rgb, bg))
        if keep_hits:
            opaque.append(Hit(t=torch.where(valid, hit.t, torch.full_like(hit.t, float("inf"))),
                              tri=hit.tri, u=hit.u, v=hit.v))
    lit_f = torch.cat(lit)
    opaque = Hit(*(torch.cat(x) for x in zip(*opaque))) if keep_hits else None

    # Transmission backdrop mips + blended / transmissive layers.
    if meta.has_blend:
        lit_img = _from_tile_order(lit_f, w, h)
        trans_mips = build_transmission_mips(lit_img if lit_gather is None
                                             else lit_gather(lit_img))
        blended = []
        for start in range(0, n, RASTER_CHUNK):
            sl = slice(start, start + RASTER_CHUNK)
            origin, direction, t_max, screen_uv = _pixel_rays(px[sl], py[sl], (fw, fh), c2w,
                                                              with_screen_uv=True)
            t_far = torch.minimum(opaque.t[sl], t_max)
            layer_rgb, layer_a = [], []
            cur_tmin = torch.zeros_like(t_max)
            for _ in range(MAX_BLEND_LAYERS):
                bh = closest_hit(scene, meta, origin, direction, cur_tmin, t_far,
                                 blend_mode=bvh_ops.BLEND_ONLY)
                ok = bh.tri >= 0
                b_mip = (torch.clamp(bh.t, min=0.0) * s0 / torch.clamp(t_max, min=1e-20)
                         if has_mips else None)
                srgb, sa, _, smode = shade_forward(
                    scene, meta, bh, origin, direction, camera_pos, env_intensity, screen_uv,
                    transmission_mips=trans_mips, use_env=use_env, mip_scale=b_mip)
                # BLEND composites by base alpha; a transmissive opaque
                # surface with alpha 1 (its colour already holds the backdrop).
                a_eff = torch.where(smode == T.ALPHA_MODE_BLEND, sa, torch.ones_like(sa))
                layer_rgb.append(srgb)
                layer_a.append(torch.where(ok, a_eff, torch.zeros_like(a_eff)))
                cur_tmin = torch.where(ok, bh.t * (1.0 + 1e-5) + 1e-6, t_max + 1.0)
            out = lit_f[sl]
            for i in range(MAX_BLEND_LAYERS - 1, -1, -1):
                out = out + layer_a[i][..., None] * (layer_rgb[i] - out)
            blended.append(out)
        lit_f = torch.cat(blended)
    lit = _from_tile_order(lit_f, w, h)

    if with_motion:
        if prev_world_to_clip is None:
            prev_world_to_clip = camera.world_to_clip(c2w_np)
        mv = motion_vectors(scene.world, opaque, px, py,
                            torch.as_tensor(prev_world_to_clip, dtype=torch.float32, device=dev),
                            prev_position, (fw, fh))
        return lit, _from_tile_order(mv, w, h)
    return lit
