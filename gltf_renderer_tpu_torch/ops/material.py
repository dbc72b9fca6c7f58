"""Surface property assembly: material rows + textures -> SurfaceProperties.

Port of gltf_renderer_tpu/ops/material.py (GetSurfaceProperties,
PathTracer.lib.hlsl:318-381, and the Material.hlsli getters) on the
compact material rows: one row gather per hit, each used texture slot's
metadata joined into the row at scene build. Textures sample level 0 of the
linear atlas (the path tracer), or the mip pyramid trilinearly at a given
level (the raster backend). The JAX package's quad-packed mip branch is a
TPU gather layout of the same texels and is not ported.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from gltf_renderer_tpu_torch.ops.bsdf import MINIMUM_ROUGHNESS, SurfaceProperties
from gltf_renderer_tpu_torch.ops.texture import _wrap, sample_atlas, transform_uv
from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.utils.math import cross, dot, normalize, reflect, trunc_i32

ALL_SLOTS = tuple(range(T.N_TEX_SLOTS))
COMPACT_SLOT_STRIDE = 16  # 7 address cols + 9 joined texture-metadata cols


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Bitcast f32 -> i32 (ids and flags ride bitcast in f32 rows)."""
    return x.contiguous().view(torch.int32)


def _slot_base(slot: int, used_slots) -> int:
    """Column of `slot` in a compact material row."""
    return T.MATERIAL_ROW_FACTORS + COMPACT_SLOT_STRIDE * tuple(sorted(used_slots)).index(slot)


def compact_material_rows(rows, used_slots, tex_rows=None) -> np.ndarray:
    """(M, 144) full rows -> (M, 34 + 16k padded to 8) rows holding only the
    scene's used slots (sorted), each slot's 7 address cols followed by the
    9 metadata cols of the texture it points at (host numpy)."""
    rows = np.asarray(rows)
    order = tuple(sorted(used_slots))
    width = T.MATERIAL_ROW_FACTORS + COMPACT_SLOT_STRIDE * len(order)
    padded = -(-max(width, 1) // 8) * 8
    out = np.zeros((rows.shape[0], padded), np.float32)
    out[:, :T.MATERIAL_ROW_FACTORS] = rows[:, :T.MATERIAL_ROW_FACTORS]
    tex = None if tex_rows is None else np.asarray(tex_rows)
    for j, s in enumerate(order):
        src = T.MATERIAL_ROW_FACTORS + T.MATERIAL_SLOT_STRIDE * s
        dst = T.MATERIAL_ROW_FACTORS + COMPACT_SLOT_STRIDE * j
        out[:, dst : dst + T.MATERIAL_SLOT_STRIDE] = rows[:, src : src + T.MATERIAL_SLOT_STRIDE]
        if tex is not None and tex.shape[0]:
            tid = rows[:, src].view(np.int32)
            meta = tex[np.clip(tid, 0, tex.shape[0] - 1), :9]
            meta[tid < 0] = 0.0
            out[:, dst + T.MATERIAL_SLOT_STRIDE : dst + T.MATERIAL_SLOT_STRIDE + 9] = meta
    return out


def _sample_mips(textures, tid, trow, uv, scl, mip_base, wrap_modes, any_nearest):
    """Trilinear fetch from the flat mip pyramid (JAX material.py:182-234,
    :294-310). tid (k, R) texture ids, trow (k, R, 9) their metadata, uv and
    scl (k, R, 2), mip_base (R,) log2 of the uv footprint -> (k, R, 4)."""
    n_tex = textures.x.shape[0]
    maxl = textures.mip_rows.shape[0] // max(n_tex, 1)
    ws = trow[..., 4].to(torch.int64)
    wt = trow[..., 5].to(torch.int64)
    is_near = trow[..., 6].to(torch.int64) == 1
    area = torch.clamp(trow[..., 2].to(torch.int64).to(torch.float32)
                       * trow[..., 3].to(torch.int64).to(torch.float32), min=1.0)
    suv = torch.clamp(torch.abs(scl[..., 0] * scl[..., 1]), min=1e-12)
    lvl = mip_base[None] + 0.5 * torch.log2(area) + 0.5 * torch.log2(suv)
    lvl = torch.clamp(lvl, 0.0, maxl - 1.0)
    if any_nearest:
        lvl = torch.where(is_near, torch.zeros_like(lvl), lvl)
    l0 = trunc_i32(torch.floor(lvl)).long()
    l1 = torch.clamp(l0 + 1, max=maxl - 1)
    lfrac = (lvl - l0.to(torch.float32)).unsqueeze(-1)
    tid_c = torch.clamp(tid.to(torch.int64), 0, max(n_tex - 1, 0))
    meta_ids = torch.stack([tid_c * maxl + l0, tid_c * maxl + l1])
    mrow2 = textures.mip_rows[meta_ids.reshape(-1)].reshape(meta_ids.shape + (4,))

    def level_corners(mrow):
        base_i = _bits(mrow[..., 0]).to(torch.int64)
        lw = mrow[..., 1].to(torch.int64)
        lh = mrow[..., 2].to(torch.int64)
        fx = uv[..., 0] * mrow[..., 1] - 0.5
        fy = uv[..., 1] * mrow[..., 2] - 0.5
        x0 = trunc_i32(torch.floor(fx))  # as texture.sample_atlas
        y0 = trunc_i32(torch.floor(fy))
        tx = (fx - x0.to(torch.float32)).unsqueeze(-1)
        ty = (fy - y0.to(torch.float32)).unsqueeze(-1)
        if any_nearest:
            x0 = torch.where(is_near, trunc_i32(torch.floor(uv[..., 0] * mrow[..., 1])), x0)
            y0 = torch.where(is_near, trunc_i32(torch.floor(uv[..., 1] * mrow[..., 2])), y0)
            tx = torch.where(is_near.unsqueeze(-1), torch.zeros_like(tx), tx)
            ty = torch.where(is_near.unsqueeze(-1), torch.zeros_like(ty), ty)

        def fi(xi, yi):
            return base_i + _wrap(yi, lh, wt, wrap_modes) * lw + _wrap(xi, lw, ws, wrap_modes)

        ids = torch.stack([fi(x0, y0), fi(x0 + 1, y0), fi(x0, y0 + 1), fi(x0 + 1, y0 + 1)])
        return ids, tx, ty

    ids0, tx0, ty0 = level_corners(mrow2[0])
    ids1, tx1, ty1 = level_corners(mrow2[1])
    ids = torch.clamp(torch.cat([ids0, ids1]), 0, max(textures.mip_flat.shape[0] - 1, 0))
    texel = textures.mip_flat[ids.reshape(-1)].reshape(ids.shape + (4,)).to(torch.float32)

    def bil(c, tx, ty):
        return (c[0] * (1 - tx) + c[1] * tx) * (1 - ty) + (c[2] * (1 - tx) + c[3] * tx) * ty

    return bil(texel[0:4], tx0, ty0) * (1 - lfrac) + bil(texel[4:8], tx1, ty1) * lfrac


def sample_slots_fused(row, textures, slots, uv0, uv1, used_slots, identity_uv=False,
                       wrap_modes=(0, 1, 2), any_nearest=True, mip_base=None):
    """Sample several texture slots from compact rows in one gather: level 0
    of the linear atlas, or with `mip_base` (R,) and a scene mip pyramid the
    trilinear mip level mip_base + log2 of each texture's size.

    Returns {slot: (rgba (R, 4), present (R,) exactly-0/1 f32)}; absent
    slots read 1.0."""
    k = len(slots)
    if k == 0:
        return {}
    ones = torch.ones(uv0.shape[:-1] + (4,), dtype=torch.float32, device=uv0.device)
    if textures.rows is None or textures.rows.shape[0] == 0:
        absent = torch.zeros(uv0.shape[:-1], dtype=torch.float32, device=uv0.device)
        return {s: (ones, absent) for s in slots}
    bases = [_slot_base(s, used_slots) for s in slots]
    tid = torch.stack([_bits(row[:, b]) for b in bases])
    uvset = torch.stack([_bits(row[:, b + 1]) for b in bases])
    rot = torch.stack([row[:, b + 2] for b in bases])
    off = torch.stack([row[:, b + 3 : b + 5] for b in bases])
    scl = torch.stack([row[:, b + 5 : b + 7] for b in bases])
    uvsel = (uvset == 1).to(torch.float32).unsqueeze(-1)
    uv = uv1.unsqueeze(0) * uvsel + uv0.unsqueeze(0) * (1.0 - uvsel)
    if not identity_uv:
        uv = transform_uv(uv, rot, off, scl)
    presf = (tid >= 0).to(torch.float32).unsqueeze(-1)
    trow = torch.stack([row[:, b + T.MATERIAL_SLOT_STRIDE : b + T.MATERIAL_SLOT_STRIDE + 9]
                        for b in bases])
    if mip_base is not None and textures.mip_flat is not None:
        out = _sample_mips(textures, tid, trow, uv, scl, mip_base, wrap_modes, any_nearest)
    else:
        ah, aw = textures.atlas.shape[0], textures.atlas.shape[1]
        out = sample_atlas(textures.atlas_linear, aw, ah, trow, uv, wrap_modes, any_nearest)
    out = out * presf + (1.0 - presf)
    return {s: (out[i], presf[i, ..., 0]) for i, s in enumerate(slots)}


def get_base_color_row(row, textures, uv0, uv1, vertex_color, used_slots=ALL_SLOTS,
                       identity_uv=False, wrap_modes=(0, 1, 2), any_nearest=True):
    """Material.hlsli GetBaseColor:98-106 on compact rows: factor x vertex
    colour x the base-colour texture at level 0 of the linear atlas."""
    base = row[:, 0:4] * vertex_color
    if T.TEX_ALBEDO not in used_slots:
        return base
    rgba, _ = sample_slots_fused(row, textures, (T.TEX_ALBEDO,), uv0, uv1, used_slots,
                                 identity_uv=identity_uv, wrap_modes=wrap_modes,
                                 any_nearest=any_nearest)[T.TEX_ALBEDO]
    return base * rgba


def get_alpha_row(row, base_color):
    """Material.hlsli GetAlpha:108-117 on the packed row."""
    mode = _bits(row[:, 33])
    cutoff = row[:, 10]
    a = base_color[..., 3]
    one = torch.ones_like(a)
    masked = torch.where(a < cutoff, torch.zeros_like(a), one)
    return torch.where(mode == T.ALPHA_MODE_BLEND, a,
                       torch.where(mode == T.ALPHA_MODE_MASK, masked, one))


def _perturb_normal(sample_rgb, presf, scale, base_normal, t2w_t, t2w_b, t2w_n):
    nm = sample_rgb * 2.0 - 1.0
    nm = torch.cat([nm[..., 0:2] * scale.unsqueeze(-1), nm[..., 2:3]], -1)
    n = normalize(nm[..., 0:1] * t2w_t + nm[..., 1:2] * t2w_b + nm[..., 2:3] * t2w_n)
    m = presf.unsqueeze(-1)
    return n * m + base_normal * (1.0 - m)


def normal_adaptation(ng, ns, v):
    """Iray local shading-normal adaptation (PathTracer.lib.hlsl:304-316)."""
    r = reflect(-v, ns)
    r_dot_ng = dot(r, ng)
    adapted = normalize(v + normalize(r - r_dot_ng * ng))
    return torch.where(r_dot_ng < 0.0, adapted, ns)


class SurfaceExtras(NamedTuple):
    emissive: Any      # (R, 3)
    occlusion: Any     # (R,)
    base_color: Any    # (R, 4)
    flags: Any         # (R,)
    alpha_mode: Any    # (R,)
    alpha_cutoff: Any  # (R,)


def get_surface_properties(materials, textures, mat_id, uv0, uv1, vertex_color, normal,
                           tangent, bitangent, geometric_normal, view,
                           use_geometric_normals: bool = False,
                           shading_normal_adaptation: bool = True,
                           used_slots: Tuple[int, ...] = ALL_SLOTS,
                           identity_uv: bool = False, wrap_modes=(0, 1, 2),
                           any_nearest: bool = True, mip_base=None):
    """Returns (SurfaceProperties, SurfaceExtras) for hits on compact rows.
    mip_base: see sample_slots_fused (None samples level 0)."""
    row = materials.rows[mat_id.long()]
    active = tuple(s for s in used_slots if s in ALL_SLOTS)
    tex = sample_slots_fused(row, textures, active, uv0, uv1, used_slots,
                             identity_uv=identity_uv, wrap_modes=wrap_modes,
                             any_nearest=any_nearest, mip_base=mip_base)
    ones = torch.ones(uv0.shape[:-1] + (4,), dtype=torch.float32, device=uv0.device)
    no = torch.zeros(uv0.shape[:-1], dtype=torch.float32, device=uv0.device)

    def slot(s):
        return tex.get(s, (ones, no))

    base_color = row[:, 0:4] * vertex_color * slot(T.TEX_ALBEDO)[0]
    albedo = base_color[..., :3]
    alpha = get_alpha_row(row, base_color)

    nrm_s, nrm_p = slot(T.TEX_NORMAL)
    shading_normal = _perturb_normal(nrm_s[..., :3], nrm_p, row[:, 12], normal,
                                     tangent[..., :3], bitangent, normal)
    if shading_normal_adaptation:
        shading_normal = normal_adaptation(geometric_normal, shading_normal, view)

    mr_s, _ = slot(T.TEX_METALLIC_ROUGHNESS)
    metalness = row[:, 4] * mr_s[..., 2]
    roughness = row[:, 5] * mr_s[..., 1]
    rough2 = torch.clamp(roughness * roughness, min=MINIMUM_ROUGHNESS)

    occ_s, occ_p = slot(T.TEX_OCCLUSION)
    occlusion = (1.0 + row[:, 6] * (occ_s[..., 0] - 1.0)) * occ_p + (1.0 - occ_p)
    em_s, _ = slot(T.TEX_EMISSIVE)
    emissive = row[:, 7:10] * em_s[..., :3]
    ior = row[:, 11]
    sp_s, _ = slot(T.TEX_SPECULAR)
    specular_factor = row[:, 13] * sp_s[..., 3]
    spc_s, _ = slot(T.TEX_SPECULAR_COLOR)
    specular_color = row[:, 14:17] * spc_s[..., :3]
    cc_s, _ = slot(T.TEX_CLEARCOAT)
    clearcoat = row[:, 17] * cc_s[..., 0]
    ccr_s, _ = slot(T.TEX_CLEARCOAT_ROUGHNESS)
    clearcoat_roughness = row[:, 18] * ccr_s[..., 1]
    ccn_s, ccn_p = slot(T.TEX_CLEARCOAT_NORMAL)
    clearcoat_normal = _perturb_normal(ccn_s[..., :3], ccn_p, row[:, 19], normal,
                                       tangent[..., :3], bitangent, normal)
    if shading_normal_adaptation:
        clearcoat_normal = normal_adaptation(geometric_normal, clearcoat_normal, view)

    # Anisotropy (Material.hlsli:245-262) — evaluated for every material.
    an_s, an_p = slot(T.TEX_ANISOTROPY)
    an_m = an_p.unsqueeze(-1)
    an_default = torch.tensor([1.0, 0.0, 1.0], dtype=torch.float32, device=uv0.device)
    an_tex = (torch.cat([an_s[..., 0:2] * 2.0 - 1.0, an_s[..., 2:3]], -1) * an_m
              + torch.broadcast_to(an_default, an_s[..., :3].shape) * (1.0 - an_m))
    a_rot = row[:, 21]
    ca, sa = torch.cos(a_rot), torch.sin(a_rot)
    adx = ca * an_tex[..., 0] - sa * an_tex[..., 1]
    ady = sa * an_tex[..., 0] + ca * an_tex[..., 1]
    a_dir = normalize(torch.stack([adx, ady], -1))
    a_strength = row[:, 20] * an_tex[..., 2]

    # Shading tangent frame (Material.hlsli:264-280).
    shading_bitangent = normalize(cross(shading_normal, tangent[..., :3]))
    shading_tangent = normalize(cross(shading_bitangent, shading_normal))
    shading_bitangent = shading_bitangent * tangent[..., 3:4]
    anis_tangent = normalize(a_dir[..., 0:1] * shading_tangent
                             + a_dir[..., 1:2] * shading_bitangent)
    anis_bitangent = normalize(cross(anis_tangent, shading_normal))
    rough2_t = torch.clamp(rough2 + (1.0 - rough2) * a_strength * a_strength,
                           min=MINIMUM_ROUGHNESS)

    shc_s, _ = slot(T.TEX_SHEEN_COLOR)
    sheen_color = row[:, 22:25] * shc_s[..., :3]
    shr_s, _ = slot(T.TEX_SHEEN_ROUGHNESS)
    sheen_roughness = row[:, 25] * shr_s[..., 3]
    sheen_rough2 = torch.clamp(sheen_roughness * sheen_roughness, min=MINIMUM_ROUGHNESS)
    tr_s, _ = slot(T.TEX_TRANSMISSION)
    transmissive = row[:, 26] * tr_s[..., 0]
    th_s, _ = slot(T.TEX_THICKNESS)
    thickness = row[:, 27] * th_s[..., 1]

    if use_geometric_normals:
        shading_normal = geometric_normal
        clearcoat_normal = geometric_normal

    sp = SurfaceProperties(
        albedo=albedo, alpha=alpha.unsqueeze(-1), metalness=metalness.unsqueeze(-1),
        roughness_squared=torch.stack([rough2_t, rough2], -1),
        shading_normal=shading_normal, anisotropy_tangent=anis_tangent,
        anisotropy_bitangent=anis_bitangent, ior=ior.unsqueeze(-1),
        specular_color=specular_color, specular_factor=specular_factor.unsqueeze(-1),
        clearcoat=clearcoat.unsqueeze(-1),
        clearcoat_roughness=torch.clamp(clearcoat_roughness, min=MINIMUM_ROUGHNESS).unsqueeze(-1),
        clearcoat_normal=clearcoat_normal, sheen_color=sheen_color,
        sheen_roughness_squared=sheen_rough2.unsqueeze(-1),
        transmissive=transmissive.unsqueeze(-1), thickness=thickness.unsqueeze(-1),
        attenuation_distance=row[:, 28:29], attenuation_color=row[:, 29:32],
    )
    extras = SurfaceExtras(
        emissive=emissive, occlusion=occlusion, base_color=base_color,
        flags=_bits(row[:, 32]), alpha_mode=_bits(row[:, 33]), alpha_cutoff=row[:, 10],
    )
    return sp, extras
