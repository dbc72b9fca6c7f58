"""Dual-filter bloom (Bjørge, "Bandwidth-Efficient Rendering").

Port of gltf_renderer_tpu/post/bloom.py (Bloom.cpp:57-164 +
BloomDownsample/Upsample.cs.hlsl): a half-resolution 5-tap downsample
chain, a 9-tap tent upsample chain that overwrites the intermediate mips,
and the composite image + strength * tent(mip 1). No threshold.

At the exact 2x mip ratios every tap lands on a fixed sub-texel offset, so
both filters are fixed stencils over edge-clamped neighbours. The JAX
package runs them as convolutions (a stride-2 4x4 one down, a 2x
lhs-dilated 6x6 one up); here each is written as shifted slices summed with
the same weights in f32, so no convolution library (and none of cuDNN's
TF32) is involved. The chain runs planar, (3, H, W), like the JAX
package's. Frames smaller than 2^iterations on a side, whose deeper mips
would be one texel wide, are refused: the JAX package's chain fails on most
of them too.

`downsample` is the channel-last entry the raster backend's transmission
backdrop calls: the 2x stencil above where the ratio is exact, else the
shader's five bilinear taps (4 x centre + 4 diagonals at +-0.5 output texel,
clamp addressing).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gltf_renderer_tpu_torch.utils.math import trunc_i32


def _pad1(img):
    """Edge-clamp pad of the last two axes of (C, H, W) by 1."""
    return F.pad(img.unsqueeze(0), (1, 1, 1, 1), mode="replicate")[0]


@functools.lru_cache(maxsize=1)
def _down_weights():
    """The 5-tap-of-2x2-boxes downsample as a 4x4 stride-2 stencil: the
    centre 2x2 box (4/8 * 1/4) and four diagonal 2x2 boxes (1/8 * 1/4)."""
    k = np.full((4, 4), 1.0 / 32.0, np.float32)
    k[1:3, 1:3] = 5.0 / 32.0
    return k


def _downsample_p(img, out_h, out_w):
    """2x downsample of planar (C, H, W): out[i, j] = sum k[a, b] *
    pad[2i + a, 2j + b] over the edge-padded crop to (2*out_h, 2*out_w)."""
    pad = _pad1(img[..., : 2 * out_h, : 2 * out_w])
    k = _down_weights()
    out = None
    for a in range(4):
        for b in range(4):
            term = float(k[a, b]) * pad[..., a : a + 2 * out_h : 2, b : b + 2 * out_w : 2]
            out = term if out is None else out + term
    return out


def _bilinear(img, u, v):
    """Bilinear sample of (H, W, C) at uv in [0, 1], clamp addressing."""
    h, w = img.shape[0], img.shape[1]
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = trunc_i32(torch.floor(fx))
    y0 = trunc_i32(torch.floor(fy))
    tx = (fx - x0.to(torch.float32)).unsqueeze(-1)
    ty = (fy - y0.to(torch.float32)).unsqueeze(-1)

    def fetch(xi, yi):
        return img[torch.clamp(yi, 0, h - 1).long(), torch.clamp(xi, 0, w - 1).long()]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    return (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty


def _uv_grid(h, w, device):
    """Texel-centre uv of an h x w image: (uu, vv), each (h, w)."""
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return uu, vv


def downsample(img, out_h, out_w):
    """BloomDownsample.cs.hlsl on channel-last (H, W, C): 4 x centre + 4
    diagonal taps at +-0.5 output texel, over 8."""
    h, w = img.shape[0], img.shape[1]
    if h >= 2 * out_h and w >= 2 * out_w:
        return _downsample_p(img.permute(2, 0, 1), out_h, out_w).permute(1, 2, 0)
    uu, vv = _uv_grid(out_h, out_w, img.device)
    du, dv = 0.5 / out_w, 0.5 / out_h
    r = 4.0 * _bilinear(img, uu, vv)
    r = r + _bilinear(img, uu + du, vv + dv)
    r = r + _bilinear(img, uu - du, vv - dv)
    r = r + _bilinear(img, uu - du, vv + dv)
    r = r + _bilinear(img, uu + du, vv - dv)
    return r / 8.0


@functools.lru_cache(maxsize=1)
def _tent_phase_weights():
    """3x3 input-neighbourhood weights (f32) of each of the four output
    phases of the 9-tap tent at the exact 2x ratio (taps at +-0.25 / +-0.75
    input texel -> fixed bilinear weights)."""
    taps = [((1, 0), 2.0), ((-1, 0), 2.0), ((0, 1), 2.0), ((0, -1), 2.0),
            ((1, 1), 1.0), ((-1, 1), 1.0), ((1, -1), 1.0), ((-1, -1), 1.0)]
    weights = {}
    for pi in (0, 1):
        for pj in (0, 1):
            wgt = np.zeros((3, 3))
            fy0 = (pi - 0.5) * 0.5
            fx0 = (pj - 0.5) * 0.5
            for (tx_, ty_), tw in taps:
                fx = fx0 + 0.5 * tx_
                fy = fy0 + 0.5 * ty_
                x0 = int(np.floor(fx))
                y0 = int(np.floor(fy))
                ax = fx - x0
                ay = fy - y0
                for dy, wy in ((y0, 1 - ay), (y0 + 1, ay)):
                    for dx, wx in ((x0, 1 - ax), (x0 + 1, ax)):
                        if wx * wy:
                            wgt[dy + 1, dx + 1] += tw * wx * wy
            weights[(pi, pj)] = (wgt / 12.0).astype(np.float32)
    return weights


def _upsample_tent_p(img, out_h, out_w):
    """2x tent upsample of planar (C, h, w): output (2i + pi, 2j + pj) is
    phase (pi, pj)'s 3x3 stencil over the edge-clamped neighbours of input
    (i, j). An odd target replicates the last row / column."""
    h, w = img.shape[-2], img.shape[-1]
    pad = _pad1(img)
    out = torch.empty(img.shape[:-2] + (2 * h, 2 * w), dtype=img.dtype, device=img.device)
    for (pi, pj), wgt in _tent_phase_weights().items():
        acc = None
        for dy in range(3):
            for dx in range(3):
                if wgt[dy, dx] == 0.0:
                    continue
                term = float(wgt[dy, dx]) * pad[..., dy : dy + h, dx : dx + w]
                acc = term if acc is None else acc + term
        out[..., pi::2, pj::2] = acc
    if out_h > 2 * h or out_w > 2 * w:
        out = F.pad(out.unsqueeze(0), (0, out_w - 2 * w, 0, out_h - 2 * h),
                    mode="replicate")[0]
    return out[..., :out_h, :out_w]


def bloom(img, iterations: int = 4, strength: float = 0.01, max_iterations: int = 6):
    """Bloom::Execute. img (H, W, 3) HDR -> img + strength * blur."""
    iterations = min(iterations, max_iterations)
    h, w = img.shape[0], img.shape[1]
    if iterations <= 0:
        return img
    if min(h, w) < 2 ** iterations:
        raise ValueError(f"bloom needs frames of at least {2 ** iterations} pixels a side "
                         f"for {iterations} mips, got {w}x{h}")
    sizes = [(h >> i, w >> i) for i in range(1, iterations + 1)]
    cur = img.permute(2, 0, 1)
    for mh, mw in sizes:
        cur = _downsample_p(cur, mh, mw)
    for i in range(iterations - 2, -1, -1):
        mh, mw = sizes[i]
        cur = _upsample_tent_p(cur, mh, mw)
    blur = _upsample_tent_p(cur, h, w).permute(1, 2, 0)
    return img + strength * blur
