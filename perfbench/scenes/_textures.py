"""Texture maps the scene generators share (host numpy, fixed content).

Each map is an (S, S, 4) u8 image as a glTF file stores it: base colour
and emissive in sRGB, normal (tangent space, +Z out of the surface),
metallic-roughness (G roughness, B metallic) and occlusion (R) linear.
Every map comes from a height field of panels, grooves and grain, so the
normal map's bumps follow the colour's seams.
"""

from __future__ import annotations

import numpy as np


def _u8(x):
    x = np.asarray(x, np.float32) * 255.0
    np.clip(x, 0.0, 255.0, out=x)
    x += 0.5
    return x.astype(np.uint8)


def rgba(rgb, alpha=None):
    """(S, S, 3) floats in [0, 1] (and an optional (S, S) alpha) -> u8 RGBA."""
    a = np.ones(rgb.shape[:2], np.float32) if alpha is None else alpha
    return _u8(np.concatenate([rgb, a[..., None]], -1))


def grain(rs, size: int, cell: int):
    """Blocky value noise in [0, 1): one random value per cell x cell block."""
    n = -(-size // cell)
    return np.kron(rs.rand(n, n).astype(np.float32), np.ones((cell, cell), np.float32))[:size, :size]


def panels(size: int, n: int, groove: int):
    """Panel index (S, S) of an n x n grid and a groove mask in [0, 1]
    (1 within `groove` texels of a panel's edge)."""
    p = size // n
    i = np.arange(size, dtype=np.int32)
    cell = i // p
    e = np.minimum(i % p, p - 1 - i % p)
    idx = cell[:, None] * n + cell[None, :]
    edge = np.minimum(e[:, None], e[None, :]).astype(np.float32)
    return idx, np.clip(1.0 - edge / max(groove, 1), 0.0, 1.0)


def normal_map(height, strength: float):
    """Tangent-space normal map of a height field (wrapping differences)."""
    h = np.asarray(height, np.float32)
    n = np.empty(h.shape + (3,), np.float32)
    n[:, 1:-1, 0] = h[:, :-2] - h[:, 2:]
    n[:, 0, 0] = h[:, -1] - h[:, 1]
    n[:, -1, 0] = h[:, -2] - h[:, 0]
    n[1:-1, :, 1] = h[:-2] - h[2:]
    n[0, :, 1] = h[-1] - h[1]
    n[-1, :, 1] = h[-2] - h[0]
    n[..., :2] *= 0.5 * strength
    n[..., 2] = 1.0
    n *= (0.5 / np.sqrt((n * n).sum(-1)))[..., None]
    n += 0.5
    return rgba(n)


def mr_map(roughness, metallic):
    """glTF metallic-roughness map: G roughness, B metallic (R unused, 1)."""
    one = np.ones_like(roughness)
    return rgba(np.stack([one, roughness, metallic], -1))


def occlusion_map(occ):
    return rgba(np.stack([occ, occ, occ], -1))
