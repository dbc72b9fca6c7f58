"""The reference's environment: the equirect sky resampled to a cube, the
luminance importance map over the octahedral square (1024^2, summed down
to 1x1), its Walker alias table, and the lookups the path tracer makes
(miss radiance, NEE sample, pdf), all worked out again from the sky the
benchmark drew."""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .common import (
    PI,
    cubemap_to_direction,
    direction_to_cubemap,
    direction_to_equirectangular,
    luminance,
    sphere_to_square,
    square_to_sphere,
    unit_square_to_uv,
    uv_to_unit_square,
)

IMPORTANCE_RESOLUTION = 1024


class Env(NamedTuple):
    cube: Any        # (6, S, S, 3) level 0
    size: int        # importance map side
    total: Any       # () luminance sum
    alias_rows: Any  # (size^2, 4): keep threshold, alias (bitcast i32), own and alias values


def _bilerp(c00, c10, c01, c11, tx, ty):
    return (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty


def sample_equirect(img, uv):
    """Bilinear, wrap-x / clamp-y."""
    h, w = img.shape[0], img.shape[1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    tx = (fx - x0f).unsqueeze(-1)
    ty = (fy - y0f).unsqueeze(-1)

    def fetch(xi, yi):
        return img[torch.clamp(yi, 0, h - 1), torch.remainder(xi, w)]

    return _bilerp(fetch(x0, y0), fetch(x0 + 1, y0), fetch(x0, y0 + 1),
                   fetch(x0 + 1, y0 + 1), tx, ty)


def _face_pixel_dirs(size, device):
    uv = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    v, u = torch.meshgrid(uv, uv, indexing="ij")
    uv2 = torch.stack([u, v], -1)
    return torch.stack([cubemap_to_direction(torch.full(u.shape, f, dtype=torch.int64,
                                                        device=device), uv2)
                        for f in range(6)], 0)


def _level_ids(face, uv, s, base_off):
    fx = uv[..., 0] * s - 0.5
    fy = uv[..., 1] * s - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    tx = (fx - x0f).unsqueeze(-1)
    ty = (fy - y0f).unsqueeze(-1)
    base = base_off + face * (s * s)

    def clip(x):
        return torch.minimum(torch.clamp(x, min=0), torch.as_tensor(s - 1, device=x.device))

    def fi(xi, yi):
        return base + clip(yi) * s + clip(xi)

    return torch.stack([fi(x0, y0), fi(x0 + 1, y0), fi(x0, y0 + 1), fi(x0 + 1, y0 + 1)]), tx, ty


def sample_cube_level(faces, direction):
    """Bilinear within one cube level, clamped at the face's edge."""
    face, uv = direction_to_cubemap(direction)
    s = faces.shape[1]
    ids, tx, ty = _level_ids(face, uv, s, 0)
    flat = faces.reshape(-1, faces.shape[-1])
    c = flat[ids.reshape(-1)].reshape(ids.shape + (faces.shape[-1],))
    return _bilerp(c[0], c[1], c[2], c[3], tx, ty)


def _sample_cube_mips(mips, direction, level):
    """Trilinear over a cube mip chain at the fractional `level`."""
    n = len(mips)
    dev = direction.device
    level = torch.clamp(level, 0.0, n - 1)
    l0 = torch.floor(level).to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=n - 1)
    frac = (level - l0.to(torch.float32)).unsqueeze(-1)
    sizes_py = [m.shape[1] for m in mips]
    offs_py = [int(o) for o in np.cumsum([0] + [6 * s * s for s in sizes_py[:-1]])]
    sizes = torch.as_tensor(sizes_py, dtype=torch.int64, device=dev)
    offs = torch.as_tensor(offs_py, dtype=torch.int64, device=dev)
    face, uv = direction_to_cubemap(direction)
    flat = torch.cat([m.reshape(-1, m.shape[-1]) for m in mips])

    def level_sample(li):
        ids, tx, ty = _level_ids(face, uv, sizes[li], offs[li])
        c = flat[ids.reshape(-1)].reshape(ids.shape + (flat.shape[-1],))
        return _bilerp(c[0], c[1], c[2], c[3], tx, ty)

    return level_sample(l0) * (1 - frac) + level_sample(l1) * frac


def build_alias_rows(importance_map) -> np.ndarray:
    """Walker / Vose alias table over the luminance-sum map (host numpy)."""
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
        big = large.pop()
        thresh[s] = q[s]
        alias[s] = big
        q[big] -= 1.0 - q[s]
        (small if q[big] < 1.0 else large).append(big)
    vals = np.asarray(importance_map, np.float32).reshape(-1)
    rows = np.zeros((n, 4), np.float32)
    rows[:, 0] = thresh.astype(np.float32)
    rows[:, 1] = alias.astype(np.int32).view(np.float32)
    rows[:, 2] = vals
    rows[:, 3] = vals[alias]
    return rows


def build(equirect, device) -> Env:
    eq = torch.as_tensor(np.asarray(equirect, np.float32), device=device)
    w = eq.shape[1]
    size = min(int(max(2 ** int(np.floor(np.log2(max(w // 8, 1)))), 64)), 1024)
    dirs = _face_pixel_dirs(size, device)
    uv = direction_to_equirectangular(dirs)
    uv = torch.stack([torch.remainder(uv[..., 0], 1.0), uv[..., 1]], -1)
    cube0 = sample_equirect(eq, uv)
    mips = [cube0]
    cur = cube0
    while cur.shape[1] > 1:
        cur = 0.25 * (cur[:, 0::2, 0::2] + cur[:, 1::2, 0::2]
                      + cur[:, 0::2, 1::2] + cur[:, 1::2, 1::2])
        mips.append(cur)
    s = IMPORTANCE_RESOLUTION
    g = (torch.arange(s, dtype=torch.float32, device=device) + 0.5) / s
    vy, ux = torch.meshgrid(g, g, indexing="ij")
    d = square_to_sphere(uv_to_unit_square(torch.stack([ux, vy], -1)))
    # log2((6 * size) / s) with the integer division first, clamped to the chain.
    mip = torch.clamp(torch.log2(torch.tensor(max((6 * size) // s, 1e-30), dtype=torch.float32)),
                      0.0, len(mips) - 1)
    lum = luminance(_sample_cube_mips(mips, d, torch.full((s, s), float(mip), device=device)))
    cur = lum
    while cur.shape[0] > 1:
        cur = cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
    rows = torch.as_tensor(build_alias_rows(lum.cpu().numpy()), device=device)
    return Env(cube=cube0, size=s, total=cur[0, 0], alias_rows=rows)


def radiance(env: Env, direction):
    return sample_cube_level(env.cube, direction)


def sample(env: Env, u4):
    """(direction, radiance, solid-angle pdf) of an alias-table draw."""
    size = env.size
    n = size * size
    b = torch.clamp((u4[..., 0] * n).to(torch.int64), max=n - 1)
    r = env.alias_rows[b]
    take_i = (u4[..., 1] >= r[..., 0]).to(torch.int64)
    take_f = take_i.to(torch.float32)
    alias_idx = r[..., 1].contiguous().view(torch.int32).to(torch.int64)
    texel = alias_idx * take_i + b * (1 - take_i)
    value = r[..., 3] * take_f + r[..., 2] * (1.0 - take_f)
    px = (texel % size).to(torch.float32)
    py = (texel // size).to(torch.float32)
    uv = torch.stack([(px + u4[..., 2]) / size, (py + u4[..., 3]) / size], -1)
    pdf = float(size) * float(size) * value / torch.clamp(env.total, min=1e-30)
    direction = square_to_sphere(uv_to_unit_square(uv))
    return direction, sample_cube_level(env.cube, direction), pdf / (4.0 * PI)


def pdf(env: Env, direction):
    """Solid-angle pdf of `direction` (the texel under floor(uv * size) - 0.5,
    truncated toward zero)."""
    size = env.size
    uv = unit_square_to_uv(sphere_to_square(direction))
    p = torch.floor(uv * size) - 0.5
    p = torch.clamp(p.to(torch.int64), 0, size - 1)
    value = env.alias_rows[p[..., 1] * size + p[..., 0]][..., 2]
    return float(size) * float(size) * value / torch.clamp(env.total, min=1e-30) / (4.0 * PI)
