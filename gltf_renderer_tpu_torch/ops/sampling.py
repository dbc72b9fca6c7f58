"""Monte-Carlo sampling routines (port of gltf_renderer_tpu/ops/sampling.py).

Cosine hemisphere, GGX NDF (isotropic, anisotropic, visible-normal)
samplers, the Walker alias table over the environment importance map
(built on the host in numpy, as in the reference) and its O(1) sampler, and
the importance-map pdf query.
"""

from __future__ import annotations

import numpy as np
import torch

from gltf_renderer_tpu_torch.ops.bsdf import ggx_anisotropic_d, ggx_d
from gltf_renderer_tpu_torch.utils.math import (
    PI,
    TAU,
    dot,
    normalize,
    saturate,
    square_to_disk,
    uv_to_unit_square,
)


def sample_cosine_hemisphere_local(u):
    """Cosine hemisphere via the concentric disk, local +z frame."""
    d = square_to_disk(uv_to_unit_square(u))
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z.unsqueeze(-1)], -1)


def sample_cosine_hemisphere(n, u):
    """Tangentless cosine-weighted sample about n (Sampling.hlsli:26-33)."""
    theta = TAU * u[..., 0]
    y = 2.0 * u[..., 1] - 1.0
    s = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    sphere = torch.stack([s * torch.cos(theta), s * torch.sin(theta), y], -1)
    return normalize(n + sphere)


def cosine_hemisphere_pdf(n, v):
    return saturate(dot(n, v, keepdims=False) / PI)


def sample_ggx_normal(a, u):
    """GGX NDF-proportional half-vector, local frame (Sampling.hlsli:41-52)."""
    phi = TAU * u[..., 0]
    u2 = u[..., 1]
    cos_t = torch.sqrt(torch.clamp((1.0 - u2) / (1.0 + (a * a - 1.0) * u2), min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)


def ggx_normal_pdf(a, n, h):
    n_dot_h = dot(n, h, keepdims=False)
    return ggx_d(a, n_dot_h) * n_dot_h


def sample_ggx_anisotropic_normal(a, u):
    """Stretched cosine-hemisphere anisotropic GGX sample; a (..., 2)."""
    h = sample_cosine_hemisphere_local(u)
    h = torch.cat([h[..., 0:2] * a, h[..., 2:3]], -1)
    return normalize(h)


def ggx_anisotropic_normal_pdf(a, h_local):
    return ggx_anisotropic_d(a, h_local) * h_local[..., 2]


def sample_ggx_visible_normal(a, v_local, u):
    """Visible-normal sampling with spherical caps (Sampling.hlsli:97-115)."""
    phi = TAU * u[..., 0]
    vz = v_local[..., 2]
    z = (1.0 - u[..., 1]) * (1.0 + vz) - vz
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    c = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), z], -1)
    hn = c + v_local
    h = torch.cat([a * hn[..., 0:2], torch.clamp(hn[..., 2:3], min=0.0)], -1)
    return normalize(h)


def build_alias_rows(importance_map) -> np.ndarray:
    """Walker/Vose alias table over the luminance-sum map (host numpy).

    Rows (S*S, 4) f32: [keep_threshold, alias_index (bitcast i32),
    value_self, value_alias] — sampling picks texel i with probability
    value_i / total, the distribution of the reference's hierarchical
    descent."""
    w = np.asarray(importance_map, np.float64).reshape(-1)
    n = w.size
    total = float(w.sum())
    p = w / total if total > 0.0 else np.full(n, 1.0 / n)
    q = p * n
    alias = np.arange(n, dtype=np.int64)
    thresh = np.ones(n, np.float64)
    small = list(np.nonzero(q < 1.0)[0])
    large = list(np.nonzero(q >= 1.0)[0])
    while small and large:
        s = small.pop()
        l = large.pop()
        thresh[s] = q[s]
        alias[s] = l
        q[l] -= 1.0 - q[s]
        (small if q[l] < 1.0 else large).append(l)
    vals = np.asarray(importance_map, np.float32).reshape(-1)
    rows = np.zeros((n, 4), np.float32)
    rows[:, 0] = thresh.astype(np.float32)
    rows[:, 1] = alias.astype(np.int32).view(np.float32)
    rows[:, 2] = vals
    rows[:, 3] = vals[alias]
    return rows


def sample_importance_alias(rows, size: int, total, u4):
    """O(1) alias sampling of the importance map: one row gather.
    u4 (R, 4): bucket pick, alias branch, in-texel x, in-texel y.
    Returns (uv, pdf) in square measure."""
    n = size * size
    b = torch.clamp((u4[..., 0] * n).to(torch.int64), max=n - 1)
    r = rows[b]
    take_i = (u4[..., 1] >= r[..., 0]).to(torch.int64)
    take_f = take_i.to(torch.float32)
    alias_idx = r[..., 1].contiguous().view(torch.int32).to(torch.int64)
    texel = alias_idx * take_i + b * (1 - take_i)
    value = r[..., 3] * take_f + r[..., 2] * (1.0 - take_f)
    px = (texel % size).to(torch.float32)
    py = (texel // size).to(torch.float32)
    uv = torch.stack([(px + u4[..., 2]) / size, (py + u4[..., 3]) / size], -1)
    pdf = float(size) * float(size) * value / torch.clamp(total, min=1e-30)
    return uv, pdf


def importance_map_pdf(importance_size: int, total, uv, alias_rows):
    """pdf query for uv (Sampling.hlsli ImportanceMapPdf:165-174), the texel
    value read from the alias rows' column 2. Keeps the reference's
    UVToPixel quirk: floor(uv * res) - 0.5 truncated toward zero."""
    size = importance_size
    p = torch.floor(uv * size) - 0.5
    p = torch.clamp(p.to(torch.int64), 0, size - 1)
    value = alias_rows[p[..., 1] * size + p[..., 0]][..., 2]
    return float(size) * float(size) * value / torch.clamp(total, min=1e-30)
