"""Tone mapping: exposure + AgX (or none) + sRGB encode + triangle dither.

Port of gltf_renderer_tpu/post/tonemap.py (ToneMapper.ps.hlsl; AgX
constants from Benjamin Wrensch's minimal AgX, after Troy Sobotka's). The
3x3 colour transforms are written out as sums in index order, so every
device rounds them the same way.
"""

from __future__ import annotations

import torch

from gltf_renderer_tpu_torch.ops.rng import M32, random_float3
from gltf_renderer_tpu_torch.render.settings import TONEMAPPER_AGX, TONEMAPPER_NONE

# HLSL float3x3 constructor rows (ToneMapper.ps.hlsl:50-55); with HLSL's
# mul(v, M) the output channel j is sum_k v[k] * ROWS[k][j].
_AGX_INSET_ROWS = (
    (0.856627153315983, 0.137318972929847, 0.11189821299995),
    (0.0951212405381588, 0.761241990602591, 0.0767994186031903),
    (0.0482516061458583, 0.101439036467562, 0.811302368396859),
)
_AGX_OUTSET_ROWS = (
    (1.12710058, -0.14132976, -0.14132976),
    (-0.11060664, 1.1578237, -0.11060664),
    (-0.01649394, -0.01649394, 1.25193641),
)
_LOG_MIN = -12.47393
_LOG_MAX = 4.026069


def _mul_rows(c, rows):
    """(..., 3) colour times an HLSL row-constructed 3x3 matrix."""
    return torch.stack([c[..., 0] * rows[0][j] + c[..., 1] * rows[1][j] + c[..., 2] * rows[2][j]
                        for j in range(3)], -1)


def agx_curve(x):
    """6th-order polynomial fit (ToneMapper.ps.hlsl:30-44)."""
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
            + 0.4298 * x2 + 0.1191 * x - 0.00232)


def agx_tonemap(color):
    """AgxTonemap (ToneMapper.ps.hlsl:47-75): linear (..., 3) -> display."""
    c = _mul_rows(color, _AGX_INSET_ROWS)
    c = torch.clamp(torch.log2(torch.clamp(c, min=1e-10)), _LOG_MIN, _LOG_MAX)
    c = (c - _LOG_MIN) / (_LOG_MAX - _LOG_MIN)
    c = _mul_rows(agx_curve(c), _AGX_OUTSET_ROWS)
    return torch.pow(torch.clamp(c, min=0.0), 2.2)


def encode_srgb(c):
    """Linear -> sRGB (Color.hlsli:9-16)."""
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(torch.clamp(c, min=1e-10), 1.0 / 2.4) - 0.055)


def dither(color, px, py, frame):
    """Triangle-noise dither (ToneMapper.ps.hlsl:77-81): two pcg3d draws
    keyed by (pixel, frame) * 2 and * 2 + 1."""
    seed = torch.stack([px.to(torch.int64) & M32, py.to(torch.int64) & M32,
                        torch.full_like(px, int(frame) & M32, dtype=torch.int64)], -1)
    s2 = (seed * 2) & M32
    tri = random_float3(s2) + random_float3((s2 + 1) & M32) - 1.0
    return color + tri / 255.0


def tonemap(hdr, tonemapper: int, exposure, frame=0, apply_dither: bool = True):
    """(H, W, 3) linear HDR -> (H, W, 3) display-encoded [0, 1]
    (ToneMapper.ps.hlsl main:84-102)."""
    color = exposure * hdr
    if tonemapper == TONEMAPPER_NONE:
        color = torch.clamp(color, 0.0, 1.0)
    elif tonemapper == TONEMAPPER_AGX:
        color = agx_tonemap(color)
    color = encode_srgb(color)
    if apply_dither:
        h, w = hdr.shape[0], hdr.shape[1]
        py, px = torch.meshgrid(torch.arange(h, device=hdr.device),
                                torch.arange(w, device=hdr.device), indexing="ij")
        color = dither(color, px, py, frame)
    return torch.clamp(color, 0.0, 1.0)


def to_u8(display):
    return torch.round(display * 255.0).to(torch.uint8)
