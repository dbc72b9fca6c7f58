"""The reference's frame: exposure 1, AgX, sRGB encode, the triangle dither
keyed by (pixel, frame index), clamp and round to u8, for any set of
pixels. The 3x3 colour transforms are written out as sums in index order."""

from __future__ import annotations

import torch

from .common import M32, random_float3

_INSET = ((0.856627153315983, 0.137318972929847, 0.11189821299995),
          (0.0951212405381588, 0.761241990602591, 0.0767994186031903),
          (0.0482516061458583, 0.101439036467562, 0.811302368396859))
_OUTSET = ((1.12710058, -0.14132976, -0.14132976),
           (-0.11060664, 1.1578237, -0.11060664),
           (-0.01649394, -0.01649394, 1.25193641))
_LOG_MIN = -12.47393
_LOG_MAX = 4.026069


def _mul_rows(c, rows):
    return torch.stack([c[..., 0] * rows[0][j] + c[..., 1] * rows[1][j] + c[..., 2] * rows[2][j]
                        for j in range(3)], -1)


def _curve(x):
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
            + 0.4298 * x2 + 0.1191 * x - 0.00232)


def agx(color):
    c = _mul_rows(color, _INSET)
    c = torch.clamp(torch.log2(torch.clamp(c, min=1e-10)), _LOG_MIN, _LOG_MAX)
    c = (c - _LOG_MIN) / (_LOG_MAX - _LOG_MIN)
    c = _mul_rows(_curve(c), _OUTSET)
    return torch.pow(torch.clamp(c, min=0.0), 2.2)


def u8_frame(hdr, px, py, frame: int):
    """(R, 3) linear radiance at pixels (px, py) of frame `frame` -> (R, 3) u8."""
    c = agx(1.0 * hdr)
    c = torch.where(c <= 0.0031308, c * 12.92,
                    1.055 * torch.pow(torch.clamp(c, min=1e-10), 1.0 / 2.4) - 0.055)
    seed = torch.stack([px.to(torch.int64) & M32, py.to(torch.int64) & M32,
                        torch.full_like(px, int(frame) & M32, dtype=torch.int64)], -1)
    s2 = (seed * 2) & M32
    tri = random_float3(s2) + random_float3((s2 + 1) & M32) - 1.0
    c = torch.clamp(c + tri / 255.0, 0.0, 1.0)
    return torch.round(c * 255.0).to(torch.uint8)
