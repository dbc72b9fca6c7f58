"""Texture helpers on the linear atlas.

Port of gltf_renderer_tpu/ops/texture.py without its quad-packed
atlases (a TPU gather layout of the same texels): `decode_atlas_linear` and
`build_atlas_mips` (host, once per scene), `transform_uv`, `_wrap` and
level-0 bilinear / nearest sampling of the flat linear atlas. The path
tracer samples level 0 (Material.hlsli:95); the raster backend samples the
mip pyramid trilinearly (ops.material.sample_slots_fused).
"""

from __future__ import annotations

import numpy as np
import torch

from gltf_renderer_tpu_torch.scene.types import WRAP_CLAMP, WRAP_MIRROR, WRAP_REPEAT
from gltf_renderer_tpu_torch.utils.math import trunc_i32


def decode_atlas_linear(tex):
    """u8 sRGB atlas -> flat (AH*AW, 4) f16 linear atlas (host numpy).

    RGB of rects flagged sRGB are decoded; alpha and linear textures are
    straight u8/255. f16 keeps the u8 precision."""
    atlas = np.asarray(tex.atlas)
    if atlas.size == 0:
        return tex._replace(atlas_linear=np.zeros((0, 4), np.float16))
    lin = atlas.astype(np.float32) / 255.0
    xs, ys = np.asarray(tex.x), np.asarray(tex.y)
    ws, hs = np.asarray(tex.width), np.asarray(tex.height)
    srgb = np.asarray(tex.srgb)
    a = 0.055

    def dec(c):
        return np.where(c <= 0.04045, c / 12.92, ((c + a) / (1 + a)) ** 2.4)

    for i in np.nonzero(srgb == 1)[0]:
        x, y, w, h = int(xs[i]), int(ys[i]), int(ws[i]), int(hs[i])
        lin[y : y + h, x : x + w, :3] = dec(lin[y : y + h, x : x + w, :3])
    return tex._replace(atlas_linear=lin.reshape(-1, atlas.shape[-1]).astype(np.float16))


def _mip_axis_np(img, axis):
    """One separable pass of GenerateMipLevel.cs.hlsl along `axis` (host):
    2-tap box on an even axis; on an odd one the 3-tap trapezoid with
    weights ((n-x), n, (1+x)) / (2n+1) at 2x, 2x+1 and Wrap(2x+2)."""
    n_in = img.shape[axis]
    if n_in == 1:
        return img
    m = np.moveaxis(img, axis, 0)
    if n_in % 2 == 0:
        out = 0.5 * (m[0::2] + m[1::2])
    else:
        n_out = n_in // 2
        x = np.arange(n_out, dtype=np.float32).reshape((n_out,) + (1,) * (m.ndim - 1))
        n = np.float32(n_out)
        s0 = m[0 : 2 * n_out : 2]
        s1 = m[1 : 2 * n_out + 1 : 2]
        s2 = m[(np.arange(n_out) * 2 + 2) % n_in]
        out = ((n - x) * s0 + n * s1 + (1.0 + x) * s2) / (2.0 * n + 1.0)
    return np.moveaxis(out, 0, axis)


def build_atlas_mips(tex):
    """Every texture's full NPOT mip chain in one flat (M, 4) f16 array plus
    (T * MAXL, 4) addressing rows [base (bitcast i32), w, h, 0] (host numpy,
    once per scene). Level 0 is the texture's linear rect; a chain that ends
    early repeats its last level, so the row table is rectangular."""
    if tex.atlas_linear is None:
        return tex
    lin = np.asarray(tex.atlas_linear)
    if lin.size == 0:
        return tex
    ah, aw = np.asarray(tex.atlas).shape[0], np.asarray(tex.atlas).shape[1]
    img = lin.reshape(ah, aw, 4).astype(np.float32)
    xs, ys = np.asarray(tex.x), np.asarray(tex.y)
    ws, hs = np.asarray(tex.width), np.asarray(tex.height)
    t = len(xs)
    chains = []
    maxl = 1
    for i in range(t):
        x, y, w, h = int(xs[i]), int(ys[i]), int(ws[i]), int(hs[i])
        chain = [img[y : y + h, x : x + w]]
        while chain[-1].shape[0] > 1 or chain[-1].shape[1] > 1:
            nxt = np.asarray(_mip_axis_np(_mip_axis_np(chain[-1], 0), 1), np.float32)
            if nxt.shape == chain[-1].shape:
                break
            chain.append(nxt)
        chains.append(chain)
        maxl = max(maxl, len(chain))
    flat_parts = []
    rows = np.zeros((t, maxl, 4), np.float32)
    bases = np.zeros((t, maxl), np.int32)
    base = 0
    for i, chain in enumerate(chains):
        for lv in range(maxl):
            level = chain[min(lv, len(chain) - 1)]
            if lv < len(chain):
                flat_parts.append(level.reshape(-1, 4))
                level_base = base
                base += level.shape[0] * level.shape[1]
            else:
                level_base = bases[i, len(chain) - 1]
            bases[i, lv] = level_base
            rows[i, lv] = (0.0, level.shape[1], level.shape[0], 0.0)
    # The base rides bitcast: f32 integers are exact only to 2^24 texels.
    rows[:, :, 0] = bases.view(np.float32)
    flat = np.concatenate(flat_parts, 0) if flat_parts else np.zeros((0, 4), np.float32)
    return tex._replace(mip_flat=flat.astype(np.float16), mip_rows=rows.reshape(t * maxl, 4))


def transform_uv(uv, rotation, offset, scale):
    """KHR_texture_transform (Material.hlsli TransformUv:68-88)."""
    su = uv[..., 0] * scale[..., 0]
    sv = uv[..., 1] * scale[..., 1]
    c = torch.cos(rotation)
    s = torch.sin(rotation)
    ru = c * su + s * sv
    rv = -s * su + c * sv
    return torch.stack([ru + offset[..., 0], rv + offset[..., 1]], -1)


def _wrap(coord, size, mode, modes=(WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR)):
    """Integer texel wrap; only the variants in `modes` are computed."""
    def rep():
        return torch.remainder(coord, size)

    def clam():
        return torch.minimum(torch.clamp(coord, min=0), size - 1)

    def mir():
        period = 2 * size
        m = torch.remainder(coord, period)
        return torch.where(m >= size, period - 1 - m, m)

    variants = {WRAP_REPEAT: rep, WRAP_CLAMP: clam, WRAP_MIRROR: mir}
    present = [m for m in (WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR) if m in modes]
    if len(present) == 1:
        return variants[present[0]]()
    out = variants[present[-1]]()
    for m in reversed(present[:-1]):
        out = torch.where(mode == m, variants[m](), out)
    return out


def sample_atlas(atlas_linear, atlas_w: int, atlas_h: int, trow, uv, wrap_modes=(0, 1, 2),
                 any_nearest=True):
    """Level-0 bilinear (or per-texture nearest) fetch from the flat linear
    atlas. trow (..., 9) texture metadata rows, uv (..., 2) -> (..., 4)."""
    ox = trow[..., 0].to(torch.int64)
    oy = trow[..., 1].to(torch.int64)
    w = trow[..., 2].to(torch.int64)
    h = trow[..., 3].to(torch.int64)
    ws = trow[..., 4].to(torch.int64)
    wt = trow[..., 5].to(torch.int64)
    nearest = trow[..., 6].to(torch.int64)
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    fx = uv[..., 0] * wf - 0.5
    fy = uv[..., 1] * hf - 0.5
    # int32 corners cast as the reference casts them (saturating; the +1
    # corner wraps in int32), and the weights taken from them, as there.
    x0 = trunc_i32(torch.floor(fx))
    y0 = trunc_i32(torch.floor(fy))
    tx = (fx - x0.to(torch.float32)).unsqueeze(-1)
    ty = (fy - y0.to(torch.float32)).unsqueeze(-1)
    if any_nearest:
        is_near = nearest == 1
        x0 = torch.where(is_near, trunc_i32(torch.floor(uv[..., 0] * wf)), x0)
        y0 = torch.where(is_near, trunc_i32(torch.floor(uv[..., 1] * hf)), y0)
        tx = torch.where(is_near.unsqueeze(-1), torch.zeros_like(tx), tx)
        ty = torch.where(is_near.unsqueeze(-1), torch.zeros_like(ty), ty)

    # Absent textures (all-zero metadata rows, masked by the caller) wrap
    # over one texel, not zero: an integer remainder by zero raises on the CPU.
    w1 = torch.clamp(w, min=1)
    h1 = torch.clamp(h, min=1)

    def flat_idx(xi, yi):
        xi = torch.clamp(_wrap(xi, w1, ws, wrap_modes) + ox, 0, atlas_w - 1)
        yi = torch.clamp(_wrap(yi, h1, wt, wrap_modes) + oy, 0, atlas_h - 1)
        return yi * atlas_w + xi

    idx = torch.stack([flat_idx(x0, y0), flat_idx(x0 + 1, y0),
                       flat_idx(x0, y0 + 1), flat_idx(x0 + 1, y0 + 1)])
    texel = atlas_linear[idx.reshape(-1)].reshape(idx.shape + (-1,)).to(torch.float32)
    c00, c10, c01, c11 = texel[0], texel[1], texel[2], texel[3]
    return (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty
