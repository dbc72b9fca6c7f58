"""Wavefront path tracer on torch — port of gltf_renderer_tpu/render/pathtracer.py.

All pixel rays advance bounce by bounce in lockstep. RNG streams match the
reference exactly: pcg4d(pixel, seed, counter) with the counter advanced in
the order GenerateNextRandom is called (PathTracer.lib.hlsl:144-148).
Every ray the tracer casts goes through ops.traverse.traverse_wide: the CUDA
kernel for tensors on the card, the plain version for tensors on the CPU.

Ported here: environment NEE + MIS, punctual-light NEE (point, spot,
directional; the binary light shadow rays merged into the bounce launch),
the layered glTF BSDF (GGX + Lambert + Fresnel mix, sheen, clearcoat and
thin transmission, each sampled as a layer of its own), alpha MASK
(any-hit rejection by re-traversal past a rejected hit, MAX_ALPHA_HOPS) and
BLEND (the stochastic alpha layer), alpha shadows (transmission as the
product of 1 - alpha over the closest hits, MAX_SHADOW_HOPS), Russian
roulette, the merged bounce + shadow launch, the NaN/Inf scrub and the
luminance clamp; the three sampling modes (layered MIS, diffuse-white and
the cosine-hemisphere fallback of material_mis=False) and the 28 debug
outputs. Layers no material of the scene has are skipped (PTMeta.has_*),
which gives the same image with fewer ops.

The two hop loops stop when no lane is left to retry, read as one scalar
on the host per hop, or at their bound. ALPHA_RETRY_HOPS and
ALPHA_SHADOW_HOPS count the hops they run: each hop is one more
traverse_wide launch, over the whole chunk.

trace_chunked cuts a call into _trace_rays calls of at most RAY_CHUNK rays
(a 1080p frame at 1 spp is one), and the host issues the whole op chain
once for each; RAY_CHUNKS counts them.

Spans (utils.spans) name the host's phases of a sample: `pt.chunk` each
_trace_rays call, `pt.k1` each traverse_wide call with its argument
preparation and hit decode, `pt.alpha_read` each hop loop's blocking read,
`pt.shade` each bounce's hit attributes and surface properties, `pt.nee`
each bounce's environment and punctual-light sampling, BSDF evaluation
and MIS (the light's unmerged shadow rays outside it).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from gltf_renderer_tpu_torch.device import resolve
from gltf_renderer_tpu_torch.env import environment as env_ops
from gltf_renderer_tpu_torch.ops import bvh as bvh_ops
from gltf_renderer_tpu_torch.ops import rng, sampling
from gltf_renderer_tpu_torch.ops.bsdf import (
    MINIMUM_ROUGHNESS,
    SurfaceProperties,
    fresnel_coat,
    gltf_bsdf,
    sheen_e_table,
)
from gltf_renderer_tpu_torch.ops.lights import sample_point_light
from gltf_renderer_tpu_torch.ops.material import (
    _bits,
    compact_material_rows,
    get_alpha_row,
    get_base_color_row,
    get_surface_properties,
)
from gltf_renderer_tpu_torch.ops.texture import build_atlas_mips, decode_atlas_linear
from gltf_renderer_tpu_torch.ops.traverse import traverse_wide
from gltf_renderer_tpu_torch.render import settings as S
from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.scene.flatten import (
    TRI_HAS_COLOR,
    TRI_HAS_TS,
    TRI_HAS_UV0,
    TRI_HAS_UV1,
    WorldGeometry,
)
from gltf_renderer_tpu_torch.utils import scene_cache, spans
from gltf_renderer_tpu_torch.utils.math import (
    PI,
    create_basis,
    cross,
    dot,
    luminance,
    max_value,
    normalize,
    reflect,
    saturate,
    sum_last,
    to_local,
    to_world,
)

# Rays per _trace_rays call: a memory bound only. A call's working set on
# an H100 is 2.3-3.3 KB a ray (two 1080p scenes' memory peak at this chunk
# less their peak at 262,144 rays, over the rays added), so 2^21 rays, a
# whole 1080p frame at 1 spp, take 5-7 GB of the card's 80.
RAY_CHUNK = 1 << 21
PACKET_TILE = 32  # pixels per tile side of the primary-ray emission order
SEED_STRIDE = 0x9E3779B9  # per-sample seed step of trace_chunked(spp > 1)
MAX_ALPHA_HOPS = 8    # re-traversals past rejected alpha-masked hits
MAX_SHADOW_HOPS = 16  # closest hits an alpha shadow ray passes through

ALPHA_RETRY_HOPS = 0   # hops run by the masked-retry loops
ALPHA_SHADOW_HOPS = 0  # hops run by the alpha-shadow loops
RAY_CHUNKS = 0         # _trace_rays calls made by trace_chunked


class PTScene(NamedTuple):
    """Device-resident inputs for one frame (fields as the JAX PTScene)."""

    world: WorldGeometry
    bvh: bvh_ops.FlatBVH          # host topology
    packed: bvh_ops.PackedBVH     # host binary tables
    materials: Any                # MaterialTable with compact `rows` on device
    textures: Any                 # TextureTable with `atlas_linear` on device
    lights: Any
    env: Any                      # env.environment.EnvMaps or None
    sheen_table: Any = None       # (16, 16) f32 Sheen_E LUT
    wide_nodes: Any = None        # (N4, 24) f32
    wide_maps: Any = None         # bvh.WideMaps (meta on device)
    leaf_records: Any = None      # (L, REC_GEO) f32
    leaf_words: Any = None        # (L, LEAF_SIZE) i32
    occluder_idx: Any = None      # unused by the port


class PTMeta(NamedTuple):
    """Static scene facts (fields as the JAX PTMeta, plus the stack bound)."""

    num_lights: int
    has_masked: bool
    has_env: bool
    has_blend: bool = False
    use_pallas: bool = False
    used_slots: tuple = ()
    has_sheen: bool = True
    has_clearcoat: bool = True
    has_transmission: bool = True
    has_alpha_layer: bool = True
    wide_root: int = 0
    shadow_prepass: bool = False
    leaf_hbm: int = 0
    identity_uv: bool = False
    wrap_modes: tuple = (0, 1, 2)
    any_nearest: bool = True
    stack_bound: int = 1          # ops.bvh.wide_stack_bound of the wide tree


class Hit(NamedTuple):
    t: Any    # (R,) f32 — t_max on a miss
    tri: Any  # (R,) i64 — original triangle id, -1 on a miss
    u: Any
    v: Any


def slot_flag_words(world, materials, order: np.ndarray) -> np.ndarray:
    """Packed id/flag words in BVH slot order (ops.bvh FLAG_* bits)."""
    am = np.asarray(world.tri_alpha_mode)[order]
    ds = np.asarray(world.tri_double_sided)[order]
    tm = np.asarray(world.tri_material)[order]
    transmissive = np.asarray(materials.transmission_factor)[tm] > 0.0
    words = order.astype(np.int64).copy()
    words |= np.where(am == T.ALPHA_MODE_MASK, bvh_ops.FLAG_MASKED, 0)
    blend = (am == T.ALPHA_MODE_BLEND) | (transmissive & (am != T.ALPHA_MODE_MASK))
    words |= np.where(blend, bvh_ops.FLAG_BLEND, 0)
    words |= np.where(ds != 0, bvh_ops.FLAG_DOUBLE_SIDED, 0)
    return words.astype(np.int32)


def _scene_meta(world, materials, textures, lights, env) -> PTMeta:
    """Static facts of a scene, as the reference derives them."""
    am = np.asarray(world.tri_alpha_mode)
    tm = np.asarray(world.tri_material)
    tex_index = np.asarray(materials.tex_index)
    transmissive = np.asarray(materials.transmission_factor)[tm] > 0.0
    used_slots = tuple(int(s) for s in range(T.N_TEX_SLOTS) if bool((tex_index[:, s] >= 0).any()))
    has_masked = bool((am == T.ALPHA_MODE_MASK).any())
    has_blend_mode = bool((am == T.ALPHA_MODE_BLEND).any())
    mrows = np.asarray(materials.rows)
    tex_rows = None if textures.rows is None else np.asarray(textures.rows)
    identity_uv = True
    wrap_set = set()
    any_nearest = False
    for s in used_slots:
        b = T.MATERIAL_ROW_FACTORS + T.MATERIAL_SLOT_STRIDE * s
        tid = mrows[:, b].view(np.int32)
        on = tid >= 0
        if not on.any():
            continue
        identity_uv = identity_uv and bool(
            (mrows[on, b + 2] == 0.0).all() and (mrows[on, b + 3:b + 5] == 0.0).all()
            and (mrows[on, b + 5:b + 7] == 1.0).all())
        if tex_rows is not None and tex_rows.shape[0]:
            trs = tex_rows[np.clip(tid[on], 0, tex_rows.shape[0] - 1)]
            wrap_set.update(int(v) for v in np.unique(trs[:, 4]))
            wrap_set.update(int(v) for v in np.unique(trs[:, 5]))
            any_nearest = any_nearest or bool((trs[:, 6] == 1.0).any())
    return PTMeta(
        num_lights=int(len(np.asarray(lights.type))),
        has_masked=has_masked,
        has_env=env is not None,
        has_blend=bool(((am == T.ALPHA_MODE_BLEND)
                        | (transmissive & (am != T.ALPHA_MODE_MASK))).any()),
        used_slots=used_slots,
        has_sheen=bool((np.asarray(materials.sheen_color_factor) > 0).any()
                       or (tex_index[:, T.TEX_SHEEN_COLOR] >= 0).any()),
        has_clearcoat=bool((np.asarray(materials.clearcoat_factor) > 0).any()
                           or (tex_index[:, T.TEX_CLEARCOAT] >= 0).any()),
        has_transmission=bool((np.asarray(materials.transmission_factor) > 0).any()
                              or (tex_index[:, T.TEX_TRANSMISSION] >= 0).any()),
        has_alpha_layer=has_masked or has_blend_mode,
        identity_uv=identity_uv,
        wrap_modes=tuple(sorted(wrap_set)) if wrap_set else (0,),
        any_nearest=any_nearest,
    )


def _to_device(tup, dev):
    """NamedTuple of host arrays or tensors -> the same with tensors on dev."""
    return tup._replace(**{
        k: torch.as_tensor(v, device=dev)
        for k, v in tup._asdict().items() if isinstance(v, (np.ndarray, torch.Tensor))
    })


def _to_host(tup):
    """NamedTuple of tensors or arrays -> the same with numpy arrays."""
    return tup._replace(**{k: v.cpu().numpy() for k, v in tup._asdict().items()
                           if isinstance(v, torch.Tensor)})


def _host_tables(world, materials, textures, lights, env):
    """(meta, tree, packed, maps, textures with mips, compact material rows)
    built on the host from host inputs."""
    meta = _scene_meta(world, materials, textures, lights, env)
    wpos = np.asarray(world.position)
    tv = np.asarray(world.tri_vertex)
    p0, p1, p2 = wpos[tv[:, 0]], wpos[tv[:, 1]], wpos[tv[:, 2]]
    tree = bvh_ops.build(p0, p1, p2)
    order = np.asarray(tree.tri_order)
    packed = bvh_ops.pack(tree, p0[order], p1[order] - p0[order], p2[order] - p0[order],
                          slot_flag_words(world, materials, order))
    maps, wide_root = bvh_ops.build_wide_maps(tree)
    meta = meta._replace(wide_root=wide_root,
                         stack_bound=bvh_ops.wide_stack_bound(maps.meta, wide_root))
    if textures.atlas_linear is None and np.asarray(textures.atlas).size:
        textures = build_atlas_mips(decode_atlas_linear(textures))
    tex_rows = None if textures.rows is None else np.asarray(textures.rows)
    mat_rows = compact_material_rows(np.asarray(materials.rows), meta.used_slots, tex_rows)
    return meta, tree, packed, maps, textures, mat_rows


def make_pt_scene(world: WorldGeometry, materials, textures, lights, env=None,
                  device="cuda", cache_dir=None) -> "tuple[PTScene, PTMeta]":
    """Build the BVH and the traversal / shading tables on the host (the
    texture mip pyramid the raster backend samples included), then place
    them on `device`. `world` may hold tensors on any device (a posed
    frame's); the build reads it on the host. With a cache root
    `cache_dir`, the host tables are read from and stored in
    utils.scene_cache under it."""
    dev = resolve(device)
    world = _to_host(world)
    directory = scene_cache.cache_dir(cache_dir)
    key = None if directory is None else scene_cache.compute_key(
        (world, materials, textures, _to_host(lights), env is not None))
    built = None if key is None else scene_cache.load(key, directory)
    if built is None:
        built = _host_tables(world, materials, textures, lights, env)
        if key is not None:
            scene_cache.store(key, built, directory)
    meta, tree, packed, maps, textures, mat_rows = built
    tex_rows = textures.rows
    scene = PTScene(
        world=_to_device(world, dev),
        bvh=tree,
        packed=packed,
        materials=materials._replace(rows=torch.as_tensor(mat_rows, device=dev)),
        textures=textures._replace(
            rows=None if tex_rows is None else torch.as_tensor(np.asarray(tex_rows), device=dev),
            atlas_linear=torch.as_tensor(np.asarray(textures.atlas_linear), device=dev),
            mip_flat=None if textures.mip_flat is None else torch.as_tensor(
                textures.mip_flat, device=dev),
            mip_rows=None if textures.mip_rows is None else torch.as_tensor(
                textures.mip_rows, device=dev)),
        lights=_to_device(lights, dev),
        env=env,
        sheen_table=torch.as_tensor(sheen_e_table(), device=dev),
        wide_nodes=torch.as_tensor(bvh_ops.assemble_wide(packed.nodes, maps.child_src),
                                   device=dev),
        wide_maps=maps._replace(meta=torch.as_tensor(maps.meta, device=dev)),
        leaf_records=torch.as_tensor(np.asarray(packed.records)[maps.leaf_ids], device=dev),
        leaf_words=torch.as_tensor(np.asarray(packed.words)[maps.leaf_ids], device=dev),
    )
    return scene, meta


def refit_pt_scene(scene: PTScene, world: WorldGeometry, lights, bvh_host) -> PTScene:
    """`scene` with moved geometry under the same topology (JAX
    Renderer._update_geometry, its refit branch), on the scene's device:
    the new world and lights, the node boxes refitted from the world's
    vertices (bvh_host: the host tree `make_pt_scene` built), the packed
    records and nodes, the wide node boxes and the leaf records. Every other
    field depends on no position (materials, textures, environment, wide
    maps, leaf words), and the PTMeta, its stack bound included, stays."""
    dev = scene.leaf_records.device
    world = _to_device(world, dev)
    tv = world.tri_vertex.long()
    p0, p1, p2 = (world.position[tv[:, k]] for k in range(3))
    refitted = bvh_ops.refit(bvh_host, p0, p1, p2)
    order = torch.as_tensor(np.asarray(bvh_host.tri_order), device=dev).long()
    packed = bvh_ops.pack_update(scene.packed, bvh_host, p0[order], (p1 - p0)[order],
                                 (p2 - p0)[order], refitted=refitted)
    leaf_ids = torch.as_tensor(np.asarray(scene.wide_maps.leaf_ids), device=dev).long()
    return scene._replace(
        world=world,
        bvh=scene.bvh._replace(aabb_min=refitted.aabb_min, aabb_max=refitted.aabb_max),
        packed=packed,
        lights=_to_device(lights, dev),
        wide_nodes=bvh_ops.assemble_wide(packed.nodes, scene.wide_maps.child_src),
        leaf_records=packed.records[leaf_ids],
    )


# ---------------------------------------------------------------------------
# Camera rays (PathTracer.lib.hlsl:131-142) and ray offsetting
# ---------------------------------------------------------------------------

def generate_camera_rays(px, py, resolution, clip_to_world, jitter):
    """px/py (R,) int; resolution (w, h); clip_to_world (4, 4) row-major."""
    w, h = resolution
    cs_x = ((px.to(torch.float32) + 0.5 + jitter[..., 0]) / w) * 2.0 - 1.0
    cs_y = -(((py.to(torch.float32) + 0.5 + jitter[..., 1]) / h) * 2.0 - 1.0)
    ones = torch.ones_like(cs_x)
    zeros = torch.zeros_like(cs_x)
    start = torch.stack([cs_x, cs_y, ones, ones], -1) @ clip_to_world.T
    end = torch.stack([cs_x, cs_y, zeros, ones], -1) @ clip_to_world.T
    origin = start[..., :3] / start[..., 3:4]
    dest = end[..., :3] / end[..., 3:4]
    return origin, dest - origin


def offset_ray(position, geometric_normal):
    """Ray Tracing Gems ch.6 origin offsetting (PathTracer.lib.hlsl:259-268)."""
    origin_thresh = 1.0 / 32.0
    float_scale = 1.0 / 65536.0
    int_scale = 256.0
    of_i = (int_scale * geometric_normal).to(torch.int32)
    pos_i = position.contiguous().view(torch.int32)
    p_i = (pos_i + torch.where(position < 0.0, -of_i, of_i)).view(torch.float32)
    return torch.where(torch.abs(position) < origin_thresh,
                       position + float_scale * geometric_normal, p_i)


# ---------------------------------------------------------------------------
# Hit attribute fetch (GetVertexAttributes, PathTracer.lib.hlsl:270-302)
# ---------------------------------------------------------------------------

class HitAttributes(NamedTuple):
    position: Any
    geometric_normal: Any   # normalized, backface-flipped
    normal: Any
    tangent: Any            # (R, 4)
    bitangent: Any
    color: Any              # (R, 4)
    uv0: Any
    uv1: Any
    material: Any           # (R,) i32
    back_face: Any          # (R,) bool
    uv_area_ratio: Any = None  # (R,) sqrt(uv0 area / world area), with_footprint only


def _generate_tangent(normal):
    """PathTracer.lib.hlsl:166-174."""
    use_y = torch.abs(normal[..., 0:1]) > torch.abs(normal[..., 1:2])
    y_axis = torch.tensor([0.0, 1.0, 0.0], device=normal.device).expand(normal.shape)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=normal.device).expand(normal.shape)
    return normalize(cross(torch.where(use_y, y_axis, x_axis), normal))


def fetch_hit_attributes(world: WorldGeometry, tri, u, v, ray_dir, with_footprint: bool = False,
                         raster_flip: bool = False) -> HitAttributes:
    """One (R, 64) tri-major row gather per hit; interpolate and flip back
    faces.

    raster_flip: Forward.ps.hlsl's back-face convention (:115-120): the
    bitangent comes from the pre-flip normal and tangent, and only the
    normals are reversed. Without it, the path tracer's (ClosestHit,
    PathTracer.lib.hlsl:842-846): normal, tangent and tangent.w are negated
    and the bitangent is built afterwards.
    with_footprint: also return uv_area_ratio (texels per metre for the
    raster backend's mip selection)."""
    row = world.tri_attr_rows[torch.clamp(tri, min=0).long()]
    r0, r1, r2 = row[:, 0:20], row[:, 20:40], row[:, 40:60]
    material = row[:, 60].contiguous().view(torch.int32)
    fbits = row[:, 61].contiguous().view(torch.int32)
    w0 = (1.0 - u - v).unsqueeze(-1)
    w1 = u.unsqueeze(-1)
    w2 = v.unsqueeze(-1)

    def interp(a, b):
        return w0 * r0[:, a:b] + w1 * r1[:, a:b] + w2 * r2[:, a:b]

    p0, p1, p2 = r0[:, 0:3], r1[:, 0:3], r2[:, 0:3]
    pos = w0 * p0 + w1 * p1 + w2 * p2
    gn_raw = cross(p1 - p0, p2 - p0)
    gn = normalize(gn_raw)
    has_ts = ((fbits & TRI_HAS_TS) != 0).unsqueeze(-1)
    normal = torch.where(has_ts, normalize(interp(3, 6)), gn)
    tangent_xyz = torch.where(has_ts, normalize(interp(6, 9)), _generate_tangent(gn))
    tangent_w = torch.where(has_ts[:, 0], r0[:, 9], torch.ones_like(u))

    back = dot(gn_raw, ray_dir, keepdims=False) > 0.0
    b3 = back.unsqueeze(-1)
    if raster_flip:
        bitangent = tangent_w.unsqueeze(-1) * normalize(cross(normal, tangent_xyz))
        gn = torch.where(b3, -gn, gn)
        normal = torch.where(b3, -normal, normal)
        tangent = torch.cat([tangent_xyz, tangent_w.unsqueeze(-1)], -1)
    else:
        gn = torch.where(b3, -gn, gn)
        normal = torch.where(b3, -normal, normal)
        tangent_xyz = torch.where(b3, -tangent_xyz, tangent_xyz)
        tangent_w = torch.where(back, -tangent_w, tangent_w)
        tangent = torch.cat([tangent_xyz, tangent_w.unsqueeze(-1)], -1)
        bitangent = tangent[..., 3:4] * normalize(cross(normal, tangent[..., :3]))

    has_col = ((fbits & TRI_HAS_COLOR) != 0).unsqueeze(-1)
    col = torch.where(has_col, interp(14, 18), torch.ones_like(r0[:, 14:18]))
    has_uv0 = ((fbits & TRI_HAS_UV0) != 0).unsqueeze(-1)
    uv0 = torch.where(has_uv0, interp(10, 12), torch.zeros_like(r0[:, 10:12]))
    has_uv1 = ((fbits & TRI_HAS_UV1) != 0).unsqueeze(-1)
    uv1 = torch.where(has_uv1, interp(12, 14), torch.zeros_like(r0[:, 12:14]))
    uv_area_ratio = None
    if with_footprint:
        ue1 = r1[:, 10:12] - r0[:, 10:12]
        ue2 = r2[:, 10:12] - r0[:, 10:12]
        uv_cross = torch.abs(ue1[:, 0] * ue2[:, 1] - ue1[:, 1] * ue2[:, 0])
        w_cross = torch.sqrt(sum_last(gn_raw * gn_raw))
        uv_area_ratio = torch.sqrt(uv_cross / torch.clamp(w_cross, min=1e-20))
    return HitAttributes(position=pos, geometric_normal=gn, normal=normal, tangent=tangent,
                         bitangent=bitangent, color=col, uv0=uv0, uv1=uv1,
                         material=material, back_face=back, uv_area_ratio=uv_area_ratio)


# ---------------------------------------------------------------------------
# Ray casts: every one goes through traverse_wide
# ---------------------------------------------------------------------------

def _traverse(scene: PTScene, meta: PTMeta, origin, direction, t_min, t_max, any_hit=False,
              cull_sign=0, blend_mode=0, mode=None) -> Hit:
    with spans.span("pt.k1"):
        t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                                   device=origin.device), t_min.shape)
        # A module-global lookup: the benchmark's K1 recorder replaces it.
        t, word, u, v = traverse_wide(
            scene.wide_nodes, scene.wide_maps.meta, scene.leaf_records, scene.leaf_words,
            origin, direction, t_min, t_max, meta.wide_root, any_hit, cull_sign, blend_mode,
            mode, stack_bound=meta.stack_bound)
        tri = torch.where(word >= 0, (word & bvh_ops.ID_MASK).to(torch.int64),
                          torch.full_like(word, -1, dtype=torch.int64))
    return Hit(t=t, tri=tri, u=u, v=v)


def closest_hit(scene, meta, origin, direction, t_min, t_max, blend_mode=0, cull_sign=0) -> Hit:
    return _traverse(scene, meta, origin, direction, t_min, t_max,
                     cull_sign=cull_sign, blend_mode=blend_mode)


def _hit_base_alpha(scene: PTScene, meta: PTMeta, tri, u, v):
    """(base colour alpha, compact material row) at (tri, u, v) hits
    (AnyHit's alpha test, PathTracer.lib.hlsl:1010-1035)."""
    row = scene.world.tri_attr_rows[torch.clamp(tri, min=0).long()]
    r0, r1, r2 = row[:, 0:20], row[:, 20:40], row[:, 40:60]
    mat = _bits(row[:, 60])
    fbits = _bits(row[:, 61])
    w0 = (1.0 - u - v).unsqueeze(-1)
    w1 = u.unsqueeze(-1)
    w2 = v.unsqueeze(-1)

    def interp(a, b):
        return w0 * r0[:, a:b] + w1 * r1[:, a:b] + w2 * r2[:, a:b]

    def flag(bit):
        return ((fbits & bit) != 0).unsqueeze(-1)

    col = torch.where(flag(TRI_HAS_COLOR), interp(14, 18), torch.ones_like(r0[:, 14:18]))
    uv0 = torch.where(flag(TRI_HAS_UV0), interp(10, 12), torch.zeros_like(r0[:, 10:12]))
    uv1 = torch.where(flag(TRI_HAS_UV1), interp(12, 14), torch.zeros_like(r0[:, 12:14]))
    mrow = scene.materials.rows[mat.long()]
    base = get_base_color_row(mrow, scene.textures, uv0, uv1, col, used_slots=meta.used_slots,
                              identity_uv=meta.identity_uv, wrap_modes=meta.wrap_modes,
                              any_nearest=meta.any_nearest)
    return base[..., 3], mrow


def _needs_alpha_retry(scene: PTScene, meta: PTMeta, hit: Hit):
    """Lanes whose hit is an alpha-masked texel below the cutoff."""
    alpha, mrow = _hit_base_alpha(scene, meta, hit.tri, hit.u, hit.v)
    is_mask = _bits(mrow[:, 33]) == T.ALPHA_MODE_MASK
    return (hit.tri >= 0) & is_mask & (alpha < mrow[:, 10])


def _alpha_retry(scene: PTScene, meta: PTMeta, hit: Hit, origin, direction, t_min, t_max,
                 cull_sign) -> Hit:
    """IgnoreHit for alpha-masked texels (PathTracer.lib.hlsl:1030-1034):
    re-traverse the lanes that need it from just past their rejected hit,
    at most MAX_ALPHA_HOPS times. Lanes that are done keep their hit and
    trace with a collapsed interval."""
    global ALPHA_RETRY_HOPS
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=origin.device),
                               hit.t.shape)
    tmin_cur = torch.broadcast_to(torch.as_tensor(t_min, dtype=torch.float32,
                                                  device=origin.device), hit.t.shape)
    need = _needs_alpha_retry(scene, meta, hit)
    for _ in range(MAX_ALPHA_HOPS):
        if not spans.host_read(need):
            break
        ALPHA_RETRY_HOPS += 1
        tmin_cur = torch.where(need, hit.t * (1.0 + 1e-5) + 1e-6, tmin_cur)
        eff_tmin = torch.where(need, tmin_cur, t_max + 1.0)
        nh = closest_hit(scene, meta, origin, direction, eff_tmin, t_max, cull_sign=cull_sign)
        hit = Hit(*(torch.where(need, n, c) for n, c in zip(nh, hit)))
        need = _needs_alpha_retry(scene, meta, hit) & need
    return hit


def trace_closest(scene, meta, origin, direction, t_min, t_max, cull_sign=0) -> Hit:
    """Closest hit honouring alpha-mask any-hit rejection."""
    hit = closest_hit(scene, meta, origin, direction, t_min, t_max, cull_sign=cull_sign)
    if not meta.has_masked:
        return hit
    return _alpha_retry(scene, meta, hit, origin, direction, t_min, t_max, cull_sign)


def trace_shadow(scene, meta, origin, direction, t_max, alpha_shadow: bool = False,
                 active=None):
    """TraceShadowRay (PathTracer.lib.hlsl:724-742). Returns transmission (R,).

    Binary mode (ACCEPT_FIRST_HIT, ShadowAnyHit:1053-1079): any geometry
    occludes, alpha-masked texels included; exactly 0 or 1. Alpha mode:
    the product of 1 - alpha over the closest hits along the ray until it
    reaches 0, at most MAX_SHADOW_HOPS hits. A scene without MASK or BLEND
    materials takes binary mode: there the first hit is opaque."""
    global ALPHA_SHADOW_HOPS
    t_min = torch.zeros(origin.shape[0], dtype=torch.float32, device=origin.device)
    act_f = torch.ones_like(t_min) if active is None else active.to(torch.float32)
    if not (alpha_shadow and meta.has_alpha_layer):
        eff_tmin = t_min * act_f + (t_max + 1.0) * (1.0 - act_f)
        hit = _traverse(scene, meta, origin, direction, eff_tmin, t_max, any_hit=True)
        return (hit.tri < 0).to(torch.float32)
    alive = act_f > 0.0
    trans = torch.ones_like(t_min)
    tmin_cur = t_min
    for _ in range(MAX_SHADOW_HOPS):
        if not spans.host_read(alive):
            break
        ALPHA_SHADOW_HOPS += 1
        eff_tmin = torch.where(alive, tmin_cur, t_max + 1.0)
        hit = closest_hit(scene, meta, origin, direction, eff_tmin, t_max)
        hit_valid = (hit.tri >= 0) & alive
        alpha, mrow = _hit_base_alpha(scene, meta, hit.tri, hit.u, hit.v)
        a = get_alpha_row(mrow, alpha.unsqueeze(-1).expand(-1, 4))
        trans = torch.where(hit_valid, trans * (1.0 - a), trans)
        alive = hit_valid & (trans > 0.0)
        tmin_cur = torch.where(alive, hit.t * (1.0 + 1e-5) + 1e-6, tmin_cur)
    return trans


def trace_bounce_and_shadow(scene, meta, o_b, d_b, tmin_b, tmax_b, o_s, d_s, tmin_s, tmax_s,
                            cull_sign=0, trace_bounce=True):
    """ONE merged launch for the next-bounce closest rays and the binary
    shadow rays born at the same hit points (lane mode: closest lanes first,
    any-hit lanes after; r env-NEE lanes, or 2r with the punctual-light
    lanes behind them). The bounce half then runs the masked-alpha retry.
    Returns (bounce Hit, shadow transmission)."""
    r = o_b.shape[0]
    if not trace_bounce:
        hit = Hit(t=torch.broadcast_to(tmax_b, (r,)),
                  tri=torch.full((r,), -1, dtype=torch.int64, device=o_b.device),
                  u=torch.zeros(r, device=o_b.device), v=torch.zeros(r, device=o_b.device))
        return hit, trace_shadow(scene, meta, o_s, d_s, tmax_s, active=tmin_s <= tmax_s)
    s_n = o_s.shape[0]
    dev = o_b.device
    origin = torch.cat([o_b, o_s])
    direction = torch.cat([d_b, d_s])
    t_min = torch.cat([torch.broadcast_to(tmin_b, (r,)), torch.broadcast_to(tmin_s, (s_n,))])
    t_max = torch.cat([torch.broadcast_to(tmax_b, (r,)), torch.broadcast_to(tmax_s, (s_n,))])
    lane_mode = torch.cat([torch.zeros(r, dtype=torch.int32, device=dev),
                           torch.ones(s_n, dtype=torch.int32, device=dev)])
    hit2 = _traverse(scene, meta, origin, direction, t_min, t_max, any_hit="lane",
                     cull_sign=cull_sign, mode=lane_mode)
    hit = Hit(t=hit2.t[:r], tri=hit2.tri[:r], u=hit2.u[:r], v=hit2.v[:r])
    if meta.has_masked:
        hit = _alpha_retry(scene, meta, hit, o_b, d_b, tmin_b, tmax_b, cull_sign)
    return hit, (hit2.tri[r:] < 0).to(torch.float32)


# ---------------------------------------------------------------------------
# Layered BSDF sampling (PathTracer.lib.hlsl:388-667)
# ---------------------------------------------------------------------------

def _sample_clearcoat(sp: SurfaceProperties, v, u2):
    n = sp.clearcoat_normal
    t, b = create_basis(n)
    h = to_world(t, b, n, sampling.sample_ggx_normal(sp.clearcoat_roughness[..., 0], u2))
    return reflect(-v, h)


def _clearcoat_pdf(sp: SurfaceProperties, v, l):
    n = sp.clearcoat_normal
    h = normalize(v + l)
    pdf = sampling.ggx_normal_pdf(sp.clearcoat_roughness[..., 0], n, h)
    return pdf / (4.0 * dot(v, h, keepdims=False))


def _sample_specular(sp: SurfaceProperties, v, u2):
    t, b, n = sp.anisotropy_tangent, sp.anisotropy_bitangent, sp.shading_normal
    h = to_world(t, b, n, sampling.sample_ggx_anisotropic_normal(sp.roughness_squared, u2))
    return reflect(-v, h)


def _specular_pdf(sp: SurfaceProperties, v, l):
    t, b, n = sp.anisotropy_tangent, sp.anisotropy_bitangent, sp.shading_normal
    h = normalize(v + l)
    pdf = sampling.ggx_anisotropic_normal_pdf(sp.roughness_squared, to_local(t, b, n, h))
    return pdf / (4.0 * dot(v, h, keepdims=False))


def _modulated_a(sp: SurfaceProperties):
    a = sp.roughness_squared[..., 1]
    return torch.clamp(a * saturate(2.0 * (sp.ior[..., 0] - 1.0)), MINIMUM_ROUGHNESS, 1.0)


def _sample_transmission(sp: SurfaceProperties, v, u2):
    """A GGX reflection about the shading normal, flipped through the
    surface: l - 2 (n.l) n."""
    t, b, n = sp.anisotropy_tangent, sp.anisotropy_bitangent, sp.shading_normal
    h = to_world(t, b, n, sampling.sample_ggx_normal(_modulated_a(sp), u2))
    l = reflect(-v, h)
    return l - 2.0 * dot(n, l) * n


def _transmission_pdf(sp: SurfaceProperties, v, l):
    n = sp.shading_normal
    l = l - 2.0 * dot(n, l) * n
    h = normalize(v + l)
    pdf = sampling.ggx_normal_pdf(_modulated_a(sp), n, h)
    return pdf / (4.0 * dot(v, h, keepdims=False))


def layer_probabilities(sp: SurfaceProperties, v, meta: PTMeta):
    """LayerProbabilities (PathTracer.lib.hlsl:535-553): (alpha, clearcoat,
    sheen, specular, diffuse, transmission). Layers the scene statically
    lacks get probability 0 with no math: the same values, fewer ops."""
    zero = torch.zeros_like(sp.alpha[..., 0])
    alpha_prob = 1.0 - sp.alpha[..., 0] if meta.has_alpha_layer else zero
    remaining = 1.0 - alpha_prob
    clearcoat_prob = sheen_prob = transmission_prob = zero
    if meta.has_clearcoat:
        fc = fresnel_coat(1.5, sp.clearcoat, torch.zeros_like(sp.albedo),
                          torch.ones_like(sp.albedo), dot(sp.clearcoat_normal, v))[..., 0]
        clearcoat_prob = fc * remaining
        remaining = remaining - clearcoat_prob
    if meta.has_sheen:
        sheen_prob = torch.where(torch.any(sp.sheen_color > 0.0, -1), 0.5, 0.0) * remaining
        remaining = remaining - sheen_prob
    specular_prob = 0.5 * remaining
    remaining = remaining - specular_prob
    if meta.has_transmission:
        transmission_prob = sp.transmissive[..., 0] * remaining
        remaining = remaining - transmission_prob
    return alpha_prob, clearcoat_prob, sheen_prob, specular_prob, remaining, transmission_prob


def bsdf_pdf(sp: SurfaceProperties, v, l, is_transmission, probs, meta: PTMeta):
    """BsdfPdf (PathTracer.lib.hlsl:555-565): the mixture's pdf; the alpha
    layer is handled by the caller."""
    _, cc_p, sh_p, sp_p, di_p, tr_p = probs
    cos_pdf = sampling.cosine_hemisphere_pdf(sp.shading_normal, l)
    refl_pdf = sp_p * _specular_pdf(sp, v, l) + di_p * cos_pdf
    if meta.has_clearcoat:
        refl_pdf = refl_pdf + cc_p * _clearcoat_pdf(sp, v, l)
    if meta.has_sheen:
        refl_pdf = refl_pdf + sh_p * cos_pdf
    if meta.has_transmission:
        return torch.where(is_transmission, tr_p * _transmission_pdf(sp, v, l), refl_pdf)
    return refl_pdf


def _bsdf_layers(meta: PTMeta, sheen_table):
    """gltf_bsdf's layer arguments: the layers the scene has."""
    return dict(sheen_table=sheen_table, enable_sheen=meta.has_sheen,
                enable_clearcoat=meta.has_clearcoat, enable_transmission=meta.has_transmission)


def evaluate_bsdf(sp: SurfaceProperties, geometric_normal, v, l,
                  settings: S.PathTracerSettings, meta: PTMeta, sheen_table=None):
    """EvaluateBsdf (PathTracer.lib.hlsl:567-593). Returns (bsdf, pdf)."""
    if settings.material_diffuse_white:
        n_dot_l = saturate(dot(sp.shading_normal, l, keepdims=False))
        return torch.broadcast_to((n_dot_l / PI).unsqueeze(-1), sp.albedo.shape), n_dot_l / PI
    kw = _bsdf_layers(meta, sheen_table)
    if settings.material_mis:
        is_t = (dot(geometric_normal, l, keepdims=False)
                * dot(geometric_normal, v, keepdims=False)) < 0.0
        probs = layer_probabilities(sp, v, meta)
        pdf = bsdf_pdf(sp, v, l, is_t, probs, meta)
        return sp.alpha * gltf_bsdf(sp, v, l, is_transmission=is_t, **kw), pdf
    n_dot_l = saturate(dot(sp.shading_normal, l, keepdims=False))
    pdf = n_dot_l / PI * sp.alpha[..., 0]
    return sp.alpha * gltf_bsdf(sp, v, l, **kw), pdf


def sample_bsdf(sp: SurfaceProperties, u3, v, settings: S.PathTracerSettings,
                meta: PTMeta, sheen_table=None):
    """SampleBsdf (PathTracer.lib.hlsl:595-667). Layered MIS selects a layer
    by the cumulative thresholds of SelectBsdf (:511-533); diffuse-white
    samples the cosine lobe of a white Lambert; material_mis=False samples
    the cosine hemisphere or passes through by alpha (:650-666).
    Returns (bsdf, l, pdf, is_transmission, use_mis)."""
    if settings.material_diffuse_white:
        n = sp.shading_normal
        l = sampling.sample_cosine_hemisphere(n, u3[..., 1:3])
        pdf = sampling.cosine_hemisphere_pdf(n, l)
        f = torch.broadcast_to((dot(n, l, keepdims=False) / PI).unsqueeze(-1), sp.albedo.shape)
        return (f, l, pdf, torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device),
                torch.ones(pdf.shape, dtype=torch.bool, device=pdf.device))
    kw = _bsdf_layers(meta, sheen_table)
    if settings.material_mis:
        probs = layer_probabilities(sp, v, meta)
        alpha_p, cc_p, sh_p, sp_p, _, tr_p = probs
        u = u3[..., 0]
        u2 = u3[..., 1:3]
        c_alpha = alpha_p
        c_cc = c_alpha + cc_p
        c_sh = c_cc + sh_p
        c_sp = c_sh + sp_p
        sel_alpha = u <= c_alpha
        sel_cc = (~sel_alpha) & (u - c_alpha <= cc_p)
        sel_sh = (~sel_alpha) & (~sel_cc) & (u - c_cc <= sh_p)
        sel_sp = (~sel_alpha) & (~sel_cc) & (~sel_sh) & (u - c_sh <= sp_p)
        sel_tr = (~sel_alpha) & (~sel_cc) & (~sel_sh) & (~sel_sp) & (u - c_sp <= tr_p)
        l_di = sampling.sample_cosine_hemisphere(sp.shading_normal, u2)
        l_sp = _sample_specular(sp, v, u2)
        l = torch.where(sel_sp.unsqueeze(-1), l_sp, l_di)  # sheen and diffuse: cosine
        if meta.has_clearcoat:
            l = torch.where(sel_cc.unsqueeze(-1), _sample_clearcoat(sp, v, u2), l)
        if meta.has_transmission:
            l = torch.where(sel_tr.unsqueeze(-1), _sample_transmission(sp, v, u2), l)
        l = torch.where(sel_alpha.unsqueeze(-1), -v, l)
        is_t = sel_tr | sel_alpha
        pdf = bsdf_pdf(sp, v, l, sel_tr, probs, meta)
        f = sp.alpha * gltf_bsdf(sp, v, l, is_transmission=sel_tr, **kw)
        # The alpha layer's override (SampleBsdf:622-628).
        pdf = torch.where(sel_alpha, alpha_p, pdf)
        f = torch.where(sel_alpha.unsqueeze(-1), 1.0 - sp.alpha, f)
        return f, l, pdf, is_t, ~sel_alpha
    pass_through = u3[..., 0] > sp.alpha[..., 0]
    n = sp.shading_normal
    l = sampling.sample_cosine_hemisphere(n, u3[..., 1:3])
    pdf = sampling.cosine_hemisphere_pdf(n, l) * sp.alpha[..., 0]
    f = sp.alpha * gltf_bsdf(sp, v, l, **kw)
    l = torch.where(pass_through.unsqueeze(-1), -v, l)
    pdf = torch.where(pass_through, 1.0 - sp.alpha[..., 0], pdf)
    f = torch.where(pass_through.unsqueeze(-1), 1.0 - sp.alpha, f)
    return f, l, pdf, pass_through, ~pass_through


# ---------------------------------------------------------------------------
# Environment hooks
# ---------------------------------------------------------------------------

def _env_radiance(scene: PTScene, meta: PTMeta, direction, params, use_env: bool):
    """Miss radiance (Miss:1037-1051)."""
    if use_env:
        return params.environment_intensity * env_ops.env_radiance(scene.env, direction)
    color = torch.as_tensor(params.environment_color, dtype=torch.float32,
                            device=direction.device)
    return params.environment_intensity * torch.broadcast_to(color, direction.shape)


def _env_sample(scene: PTScene, meta: PTMeta, u4, params):
    d, c, pdf = env_ops.env_sample(scene.env, u4)
    return d, params.environment_intensity * c, pdf


def _env_pdf(scene: PTScene, meta: PTMeta, direction):
    return env_ops.env_pdf(scene.env, direction)


def _balance_heuristic(pdf, other_pdf):
    return pdf / torch.clamp(pdf + other_pdf, min=1e-20)


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

def _tile_order(w: int, h: int, device, tile: int = PACKET_TILE):
    """Pixel emission order in 32x32 tiles over the edge-clamp-padded image:
    (px, py, valid), each of length ceil(h/tile)*ceil(w/tile)*tile^2."""
    hp = -(-h // tile) * tile
    wp = -(-w // tile) * tile
    ty, tx = torch.meshgrid(torch.arange(0, hp, tile, device=device),
                            torch.arange(0, wp, tile, device=device), indexing="ij")
    iy, ix = torch.meshgrid(torch.arange(tile, device=device),
                            torch.arange(tile, device=device), indexing="ij")
    px = (tx.reshape(-1, 1) + ix.reshape(1, -1)).reshape(-1)
    py = (ty.reshape(-1, 1) + iy.reshape(1, -1)).reshape(-1)
    valid = (px < w) & (py < h)
    return (torch.clamp(px, max=w - 1).to(torch.int32),
            torch.clamp(py, max=h - 1).to(torch.int32), valid)


def _from_tile_order(stream, w: int, h: int, tile: int = PACKET_TILE):
    """(N', C...) tile-order stream -> (h, w, C...) image."""
    hp = -(-h // tile) * tile
    wp = -(-w // tile) * tile
    c_shape = tuple(stream.shape[1:])
    x = stream.reshape((hp // tile, wp // tile, tile, tile) + c_shape)
    x = torch.movedim(x, 2, 1)
    return x.reshape((hp, wp) + c_shape)[:h, :w]


def _to_tile_order(img, tile: int = PACKET_TILE):
    """(h, w, C...) image -> (N', C...) tile-order stream (edge-clamp pad)."""
    h, w = img.shape[0], img.shape[1]
    hp = -(-h // tile) * tile
    wp = -(-w // tile) * tile
    yi = torch.clamp(torch.arange(hp, device=img.device), max=h - 1)
    xi = torch.clamp(torch.arange(wp, device=img.device), max=w - 1)
    img = img[yi][:, xi]
    x = img.reshape((hp // tile, tile, wp // tile, tile) + tuple(img.shape[2:]))
    x = torch.movedim(x, 1, 2)
    return x.reshape((hp * wp,) + tuple(img.shape[2:]))


def trace(scene: PTScene, meta: PTMeta, settings: S.PathTracerSettings,
          params: S.PathTracerParams, clip_to_world, resolution, seed,
          pixel_offset=(0, 0), full_resolution=None, with_stats: bool = False,
          chunk: int = RAY_CHUNK):
    """One progressive sample per pixel. Returns (h, w, 3) radiance (and
    the [ray_count, nan_count] stats with with_stats). A tile of a larger
    image: `resolution` is the tile's (w, h), `pixel_offset` the image
    pixel of its (0, 0) and `full_resolution` the image's (w, h)."""
    return trace_chunked(scene, meta, settings, params, clip_to_world, resolution, seed,
                         pixel_offset=pixel_offset, full_resolution=full_resolution,
                         with_stats=with_stats, chunk=chunk, spp=1)


def trace_chunked(scene: PTScene, meta: PTMeta, settings: S.PathTracerSettings,
                  params: S.PathTracerParams, clip_to_world, resolution, seed,
                  pixel_offset=(0, 0), full_resolution=None, with_stats: bool = False,
                  chunk: int = RAY_CHUNK, spp: int = 1):
    """Trace `chunk` rays per _trace_rays call. spp > 1 traces that many
    samples per pixel in the same call (the pixel slice shrinks to
    chunk/spp) and returns their mean; sample k is keyed by
    seed + k*0x9E3779B9 (uint32 wrap), the reference's sample schedule.

    pixel_offset and full_resolution place a tile in its image, as in
    `trace`: camera rays and the RNG read absolute pixel coordinates, so a
    tile's pixels are the image's. Tile rows past the image's bottom are
    traced as extrapolated camera rays (the caller crops them)."""
    global RAY_CHUNKS
    if chunk % spp:
        raise ValueError(f"chunk {chunk} is not a multiple of spp {spp}")
    dev = scene.wide_nodes.device
    w, h = resolution
    full_resolution = resolution if full_resolution is None else full_resolution
    c2w = torch.as_tensor(np.asarray(clip_to_world, np.float32), device=dev)
    px_f, py_f, valid_f = _tile_order(w, h, dev)
    px_f = px_f + int(pixel_offset[0])
    py_f = py_f + int(pixel_offset[1])
    n = px_f.shape[0]
    chunk_pix = chunk // spp
    seeds = torch.as_tensor([(int(seed) + k * SEED_STRIDE) & rng.M32 for k in range(spp)],
                            dtype=torch.int64, device=dev)
    outs = []
    stats = torch.zeros(2, dtype=torch.float32, device=dev)
    for start in range(0, n, chunk_pix):
        cpx = px_f[start:start + chunk_pix]
        cpy = py_f[start:start + chunk_pix]
        cva = valid_f[start:start + chunk_pix]
        m = cpx.shape[0]
        seed_vec = seeds.repeat_interleave(m) if spp > 1 else seeds[0]
        RAY_CHUNKS += 1
        with spans.span("pt.chunk"):
            col, st = _trace_rays(scene, meta, settings, params, c2w, full_resolution,
                                  seed_vec, cpx.repeat(spp), cpy.repeat(spp), cva.repeat(spp))
        if spp > 1:
            col = col.reshape(spp, m, 3)
            acc = col[0]
            for k in range(1, spp):
                acc = acc + col[k]
            col = acc / spp
        outs.append(col)
        stats = stats + st
    color = _from_tile_order(torch.cat(outs, 0), w, h)
    return (color, stats) if with_stats else color


def _trace_rays(scene: PTScene, meta: PTMeta, settings: S.PathTracerSettings,
                params: S.PathTracerParams, clip_to_world, full_resolution, seed, px, py,
                valid=None):
    """Trace a flat batch of pixel rays -> ((R, 3) color, [ray_count, nan_count]).
    With a debug output, the (R, 3) debug value at the first hit, raw (no
    scrub, no clamp), and [ray_count, 0]."""
    n_rays = px.shape[0]
    dev = px.device
    counter = 0

    def rand4():
        nonlocal counter
        r = rng.pt_random(px, py, seed, counter)
        counter += 1
        return r

    def full(value):
        return torch.full((n_rays,), value, dtype=torch.float32, device=dev)

    jitter = rand4()[..., 0:2] - 0.5
    origin, direction_raw = generate_camera_rays(
        px, py, (full_resolution[0], full_resolution[1]), clip_to_world, jitter)
    # Primary ray: t in [0, |dir|], direction normalized (RayGeneration:756).
    ray_len = torch.sqrt(torch.clamp(sum_last(direction_raw * direction_raw), min=1e-20))
    direction = direction_raw / ray_len.unsqueeze(-1)
    t_max = ray_len

    radiance = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    prefix = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    rr_state = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    alive = (torch.ones(n_rays, dtype=torch.bool, device=dev) if valid is None
             else valid.to(torch.bool))
    prev_pdf = full(0.0)
    prev_mis = torch.zeros(n_rays, dtype=torch.bool, device=dev)
    ray_count = torch.zeros((), dtype=torch.float32, device=dev)
    zero3 = torch.zeros((), dtype=torch.float32, device=dev)

    nee_env = settings.environment_map and settings.environment_mis
    nee_lights = settings.point_lights and meta.num_lights > 0
    # Binary light shadows ride the merged bounce launch (see below).
    merge_light_shadow = (nee_lights and settings.shadow_rays
                          and settings.merged_light_dispatch
                          and not (settings.alpha_shadows and meta.has_alpha_layer))
    primary_cull = 1 if settings.cull_backface else 0
    bounce_cull = -1 if settings.cull_backface else 0

    eff_tmin = torch.where(alive, full(0.0), t_max + 1.0)
    hit = trace_closest(scene, meta, origin, direction, eff_tmin, t_max, cull_sign=primary_cull)

    for bounce in range(settings.max_bounces + 1):
        ray_count = ray_count + torch.sum(alive.to(torch.float32))

        # Miss -> environment (Miss, PathTracer.lib.hlsl:1037-1051).
        miss = alive & (hit.tri < 0)
        use_env = settings.environment_map and meta.has_env
        env_col = _env_radiance(scene, meta, normalize(direction), params, use_env)
        if use_env and settings.environment_mis:
            mis_w = torch.where(
                prev_mis,
                _balance_heuristic(prev_pdf, _env_pdf(scene, meta, normalize(direction))),
                torch.ones_like(prev_pdf))
            env_col = env_col * mis_w.unsqueeze(-1)
        radiance = radiance + torch.where(miss.unsqueeze(-1), prefix * env_col, zero3)
        alive = alive & (~miss)

        with spans.span("pt.shade"):
            attrs = fetch_hit_attributes(scene.world, hit.tri, hit.u, hit.v, direction)
            view = -direction
            sp, extras = get_surface_properties(
                scene.materials, scene.textures, attrs.material, attrs.uv0, attrs.uv1,
                attrs.color, attrs.normal, attrs.tangent, attrs.bitangent,
                attrs.geometric_normal, view,
                use_geometric_normals=settings.material_use_geometric_normals,
                shading_normal_adaptation=settings.shading_normal_adaptation,
                used_slots=meta.used_slots, identity_uv=meta.identity_uv,
                wrap_modes=meta.wrap_modes, any_nearest=meta.any_nearest,
            )
        if bounce == 0 and settings.debug_output != S.DEBUG_NONE:
            debug_value = _debug_channel(settings.debug_output, attrs, sp, view, alive)
            if debug_value is not None:
                return debug_value, torch.stack([ray_count, torch.zeros_like(ray_count)])

        ray_origin = offset_ray(attrs.position, attrs.geometric_normal)
        ray_origin_below = offset_ray(attrs.position, -attrs.geometric_normal)

        # Emissive (ClosestHit:924-926).
        radiance = radiance + torch.where(alive.unsqueeze(-1), prefix * extras.emissive, zero3)

        # Environment NEE + MIS (ClosestHit:928-942). The shadow ray is
        # traced in the merged launch with the next bounce's rays below.
        nee_pending = None
        if bounce < settings.max_bounces and nee_env and meta.has_env:
            with spans.span("pt.nee"):
                u_env = rand4()
                l_dir, l_col, l_pdf = _env_sample(scene, meta, u_env, params)
                f, f_pdf = evaluate_bsdf(sp, attrs.geometric_normal, view, l_dir, settings,
                                         meta, scene.sheen_table)
                mis = _balance_heuristic(l_pdf, f_pdf)
                contrib = (mis.unsqueeze(-1) * f * l_col) / torch.clamp(l_pdf.unsqueeze(-1),
                                                                        min=1e-20)
                ok = alive & torch.any(l_col > 0.0, -1)
                # Zero-BSDF lanes trace dead; the ok-mask selects OUTSIDE the
                # prefix product so an inf prefix on a dead lane cannot mint a
                # NaN (the reference's fix at pathtracer.py:1791-1802).
                s_active = ok & torch.any(f > 0.0, -1)
                nee_pending = (ray_origin, l_dir,
                               torch.where(ok.unsqueeze(-1), prefix * contrib, zero3), s_active)

        # Punctual-light NEE (ClosestHit:944-956). With binary shadows and a
        # bounce launch to follow, the light's shadow rays ride that merged
        # launch; the contribution is added after it, light before env, the
        # order of the unmerged path.
        light_pending = None
        if nee_lights:
            with spans.span("pt.nee"):
                u_l = rand4()[..., 0]
                light_ray, l_pdf = sample_point_light(
                    scene.lights, meta.num_lights, origin + direction * hit.t.unsqueeze(-1), u_l)
            l_col = light_ray.color
            merged = merge_light_shadow and bounce < settings.max_bounces
            if settings.shadow_rays and not merged:
                shadow = trace_shadow(scene, meta, ray_origin, light_ray.direction,
                                      full(params.max_ray_length),
                                      alpha_shadow=settings.alpha_shadows, active=alive)
                ray_count = ray_count + torch.sum(alive.to(torch.float32))
                l_col = l_col * shadow.unsqueeze(-1)
            with spans.span("pt.nee"):
                f, _ = evaluate_bsdf(sp, attrs.geometric_normal, view, light_ray.direction,
                                     settings, meta, scene.sheen_table)
                ok = alive & torch.any(l_col > 0.0, -1)
                l_contrib = torch.where(ok.unsqueeze(-1), prefix * (l_col * f) / l_pdf, zero3)
            if merged:
                # Zero-contribution lanes trace dead, as the env lanes do.
                light_pending = (ray_origin, light_ray.direction, l_contrib,
                                 ok & torch.any(f > 0.0, -1))
                ray_count = ray_count + torch.sum(alive.to(torch.float32))
            else:
                radiance = radiance + l_contrib

        # Bounce (ClosestHit:958-1006).
        if bounce < settings.max_bounces:
            u3 = rand4()[..., 0:3]
            f, l_dir, pdf, is_t, use_mis = sample_bsdf(sp, u3, view, settings, meta,
                                                       scene.sheen_table)
            weight = torch.where(pdf.unsqueeze(-1) != 0.0, f / pdf.unsqueeze(-1), zero3)
            throughput = rr_state * weight
            if bounce == 0 and settings.debug_output in _BOUNCE_CHANNELS:
                dv = {
                    S.DEBUG_BOUNCE_DIRECTION: lambda: 0.5 * (l_dir + 1.0),
                    S.DEBUG_BOUNCE_BSDF: lambda: f,
                    S.DEBUG_BOUNCE_PDF: lambda: torch.broadcast_to(pdf.unsqueeze(-1), f.shape),
                    S.DEBUG_BOUNCE_WEIGHT: lambda: weight,
                    S.DEBUG_BOUNCE_IS_TRANSMISSION: lambda: torch.where(
                        is_t.unsqueeze(-1), _const(dev, 0.0, 1.0, 0.0), _const(dev, 1.0, 0.0, 0.0)),
                }[settings.debug_output]()
                return (torch.where(alive.unsqueeze(-1), dv, zero3),
                        torch.stack([ray_count, torch.zeros_like(ray_count)]))
            u_rr = rand4()[..., 0]
            continue_prob = torch.clamp(max_value(throughput)[..., 0],
                                        params.min_russian_roulette_continue_prob,
                                        params.max_russian_roulette_continue_prob)
            if bounce >= settings.min_bounces:
                cont = u_rr < continue_prob
                weight = weight / torch.where(cont, continue_prob,
                                              torch.ones_like(continue_prob)).unsqueeze(-1)
            else:
                cont = torch.ones(n_rays, dtype=torch.bool, device=dev)
            alive = alive & cont & torch.any(throughput > 0.0, -1)
            prefix = prefix * weight
            rr_state = throughput * weight  # quirk kept: affects only RR (:995-1003)
            origin = torch.where(is_t.unsqueeze(-1), ray_origin_below, ray_origin)
            direction = l_dir
            t_max = full(params.max_ray_length)
            prev_pdf = pdf
            prev_mis = use_mis

            eff_tmin = torch.where(alive, full(0.0), t_max + 1.0)
            trace_bounce = not settings.indirect_environment_only
            sets = [x for x in (nee_pending, light_pending) if x is not None]
            if sets:
                s_tmax1 = full(params.max_ray_length)
                s_tmin = torch.cat([torch.where(x[3], full(0.0), s_tmax1 + 1.0) for x in sets])
                hit, shadow = trace_bounce_and_shadow(
                    scene, meta, origin, direction, eff_tmin, t_max,
                    torch.cat([x[0] for x in sets]), torch.cat([x[1] for x in sets]),
                    s_tmin, torch.cat([s_tmax1] * len(sets)),
                    cull_sign=bounce_cull, trace_bounce=trace_bounce)
                if light_pending is not None:
                    l_trans = shadow[n_rays * (len(sets) - 1):]
                    radiance = radiance + light_pending[2] * l_trans.unsqueeze(-1)
                if nee_pending is not None:
                    radiance = radiance + nee_pending[2] * shadow[:n_rays].unsqueeze(-1)
                    ray_count = ray_count + torch.sum(nee_pending[3].to(torch.float32))
            elif trace_bounce:
                hit = trace_closest(scene, meta, origin, direction, eff_tmin, t_max,
                                    cull_sign=bounce_cull)
            else:
                hit = Hit(t=t_max, tri=torch.full((n_rays,), -1, dtype=torch.int64, device=dev),
                          u=full(0.0), v=full(0.0))

    # NaN/INF scrub + luminance clamp (RayGeneration:760-774).
    nan_mask = torch.any(torch.isnan(radiance), -1)
    inf_mask = torch.any(torch.isinf(radiance), -1)
    nan_count = (torch.sum(nan_mask.to(torch.float32)) + torch.sum(inf_mask.to(torch.float32)))
    red = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    black = torch.zeros(3, dtype=torch.float32, device=dev)
    radiance = torch.where(nan_mask.unsqueeze(-1), red if settings.show_nan else black, radiance)
    radiance = torch.where(inf_mask.unsqueeze(-1), red if settings.show_inf else black, radiance)
    if settings.luminance_clamp_enabled:
        lum = luminance(radiance)
        scale = torch.where(lum > params.luminance_clamp,
                            params.luminance_clamp / torch.clamp(lum, min=1e-20),
                            torch.ones_like(lum))
        radiance = radiance * scale.unsqueeze(-1)
    return radiance, torch.stack([ray_count, nan_count])


_BOUNCE_CHANNELS = (S.DEBUG_BOUNCE_DIRECTION, S.DEBUG_BOUNCE_BSDF, S.DEBUG_BOUNCE_PDF,
                    S.DEBUG_BOUNCE_WEIGHT, S.DEBUG_BOUNCE_IS_TRANSMISSION)


def _const(dev, *values):
    return torch.tensor(values, dtype=torch.float32, device=dev)


def _debug_channel(which, attrs: HitAttributes, sp: SurfaceProperties, view, alive):
    """The debug outputs read at the first hit (ClosestHit:806-922), (R, 3)
    with 0 on lanes that missed; None for the bounce-stage channels, which
    _trace_rays takes after sample_bsdf."""
    def vis(x):
        return torch.where(alive.unsqueeze(-1), x, torch.zeros((), device=x.device))

    def grey(x):
        return x.repeat_interleave(3, -1)

    dev = view.device
    if which == S.DEBUG_HIT_KIND:
        return vis(torch.where(attrs.back_face.unsqueeze(-1), _const(dev, 0.0, 1.0, 0.0),
                               _const(dev, 1.0, 0.0, 0.0)))
    if which == S.DEBUG_HEMISPHERE_VIEW_SIDE:
        side = dot(view, sp.shading_normal, keepdims=False) > 0.0
        return vis(torch.where(side.unsqueeze(-1), _const(dev, 0.0, 1.0, 0.0),
                               _const(dev, 1.0, 0.0, 0.0)))
    if which in (S.DEBUG_TEXCOORD_0, S.DEBUG_TEXCOORD_1):
        uv = attrs.uv0 if which == S.DEBUG_TEXCOORD_0 else attrs.uv1
        return vis(torch.cat([uv, torch.zeros_like(uv[..., :1])], -1))
    channel = {
        S.DEBUG_VERTEX_COLOR: lambda: attrs.color[..., :3],
        S.DEBUG_VERTEX_ALPHA: lambda: grey(attrs.color[..., 3:4]),
        S.DEBUG_VERTEX_NORMAL: lambda: (attrs.normal + 1.0) / 2.0,
        S.DEBUG_VERTEX_TANGENT: lambda: (attrs.tangent[..., :3] + 1.0) / 2.0,
        S.DEBUG_VERTEX_BITANGENT: lambda: (attrs.bitangent + 1.0) / 2.0,
        S.DEBUG_COLOR: lambda: sp.albedo,
        S.DEBUG_ALPHA: lambda: grey(sp.alpha),
        S.DEBUG_SHADING_NORMAL: lambda: (sp.shading_normal + 1.0) / 2.0,
        S.DEBUG_SHADING_TANGENT: lambda: (sp.anisotropy_tangent + 1.0) / 2.0,
        S.DEBUG_SHADING_BITANGENT: lambda: (sp.anisotropy_bitangent + 1.0) / 2.0,
        S.DEBUG_METALNESS: lambda: grey(sp.metalness),
        S.DEBUG_ROUGHNESS: lambda: grey(torch.sqrt(sp.roughness_squared[..., 1:2])),
        S.DEBUG_SPECULAR: lambda: grey(sp.specular_factor),
        S.DEBUG_SPECULAR_COLOR: lambda: sp.specular_color,
        S.DEBUG_CLEARCOAT: lambda: grey(sp.clearcoat),
        S.DEBUG_CLEARCOAT_ROUGHNESS: lambda: grey(sp.clearcoat_roughness),
        S.DEBUG_CLEARCOAT_NORMAL: lambda: (sp.clearcoat_normal + 1.0) / 2.0,
        S.DEBUG_TRANSMISSIVE: lambda: grey(sp.transmissive),
    }.get(which)
    return None if channel is None else vis(channel())


def accumulate(history, frame, accumulated_frames, settings: S.PathTracerSettings):
    """Running-mean accumulation (RayGeneration:776-786)."""
    if not settings.accumulate:
        return frame
    blend = 1.0 / (accumulated_frames.to(torch.float32) + 1.0)
    return torch.where(accumulated_frames > 0, history + (frame - history) * blend, frame)
