"""Vector math and the pcg hashes, on torch tensors (vectors on the last
axis). Sums over the last axis are written out term by term in index
order, so every device rounds them the same way."""

from __future__ import annotations

import torch

PI = 3.14159265359
TAU = 2.0 * PI
M32 = 0xFFFFFFFF
_U32_MAX_F = 4294967295.0


def trunc_i32(x):
    """int32 toward zero, saturated, NaN to 0 (as a CUDA cvt.rzi.s32.f32)."""
    if x.is_cuda:
        return x.to(torch.int32)
    return x.double().nan_to_num(0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def sum_last(x):
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def dot(a, b, keepdims=True):
    d = sum_last(a * b)
    return d.unsqueeze(-1) if keepdims else d


def normalize(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp(sum_last(v * v), min=eps)).unsqueeze(-1)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def max_value(color):
    return torch.amax(color, dim=-1, keepdim=True)


def create_basis(n):
    use_x = torch.abs(n[..., 0:1]) > torch.abs(n[..., 2:3])
    zero = torch.zeros_like(n[..., 0])
    b1 = torch.stack([-n[..., 1], n[..., 0], zero], -1)
    b2 = torch.stack([zero, -n[..., 2], n[..., 1]], -1)
    b = normalize(torch.where(use_x, b1, b2))
    return cross(b, n), b


def to_local(t, b, n, v):
    return torch.cat([dot(t, v), dot(b, v), dot(n, v)], -1)


def to_world(t, b, n, v_local):
    return v_local[..., 0:1] * t + v_local[..., 1:2] * b + v_local[..., 2:3] * n


def reflect(i, n):
    return i - 2.0 * dot(n, i) * n


def uv_to_unit_square(uv):
    return torch.stack([uv[..., 0] * 2.0 + -1.0, uv[..., 1] * -2.0 + 1.0], -1)


def unit_square_to_uv(sq):
    return torch.stack([(sq[..., 0] - -1.0) * 0.5, (sq[..., 1] - 1.0) * -0.5], -1)


def square_to_disk(square):
    ax = torch.abs(square[..., 0])
    ay = torch.abs(square[..., 1])
    r = torch.maximum(ax, ay)
    safe_r = torch.where(r == 0, torch.ones_like(r), r)
    phi = torch.where(r == 0.0, torch.zeros_like(r), PI * (r + (ay - ax)) / (4.0 * safe_r))
    x = torch.sign(square[..., 0]) * r * torch.cos(phi)
    y = torch.sign(square[..., 1]) * r * torch.sin(phi)
    return torch.stack([x, y], -1)


def square_to_sphere(square):
    ax = torch.abs(square[..., 0])
    ay = torch.abs(square[..., 1])
    d = 1.0 - (ax + ay)
    r = 1.0 - torch.abs(d)
    safe_r = torch.where(r == 0.0, torch.ones_like(r), r)
    phi = torch.where(r == 0.0, torch.zeros_like(r), (PI / 4.0) * ((ay - ax) / safe_r + 1.0))
    f = r * torch.sqrt(torch.clamp(2.0 - r * r, min=0.0))
    x = f * torch.sign(square[..., 0]) * torch.cos(phi)
    y = f * torch.sign(square[..., 1]) * torch.sin(phi)
    z = torch.sign(d) * (1.0 - r * r)
    return torch.stack([x, y, z], -1)


def sphere_to_square(sphere):
    z = sphere[..., 2]
    r = torch.sqrt(torch.clamp(1.0 - torch.abs(z), min=0.0))
    phi = torch.atan2(torch.abs(sphere[..., 1]), torch.abs(sphere[..., 0]))
    d = torch.sign(z) * (1.0 - r)
    diff = r * ((4.0 / PI) * phi - 1.0)
    x = torch.sign(sphere[..., 0]) * 0.5 * (1.0 - d - diff)
    y = torch.sign(sphere[..., 1]) * 0.5 * (1.0 - d + diff)
    return torch.stack([x, y], -1)


def direction_to_equirectangular(d):
    u = torch.atan2(d[..., 1], d[..., 0]) / TAU
    v = 1.0 - ((d[..., 2] + 1.0) / 2.0)
    return torch.stack([u, v], -1)


def cubemap_to_direction(face, uv):
    su = uv[..., 0] * 2.0 - 1.0
    sv = uv[..., 1] * 2.0 - 1.0
    one = torch.ones_like(su)

    def pick(c0, c1, c2, c3, c4, c5):
        return torch.where(face == 0, c0, torch.where(face == 1, c1, torch.where(
            face == 2, c2, torch.where(face == 3, c3, torch.where(face == 4, c4, c5)))))

    x = pick(one, -one, su, su, su, -su)
    y = pick(-sv, -sv, one, -one, -sv, -sv)
    z = pick(-su, su, sv, -sv, one, -one)
    return normalize(torch.stack([x, y, z], -1))


def direction_to_cubemap(d):
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    def sel(c, a, b):
        return torch.where(c, torch.as_tensor(a, device=d.device),
                           torch.as_tensor(b, device=d.device))

    face = torch.where(is_x, sel(dx >= 0, 0, 1),
                       torch.where(is_y, sel(dy >= 0, 2, 3), sel(dz >= 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    one = torch.ones_like(dx)
    sx = torch.where(dx >= 0, one, -one)
    sy = torch.where(dy >= 0, one, -one)
    sz = torch.where(dz >= 0, one, -one)
    u = torch.where(is_x, -sx * dz, torch.where(is_y, dx, sz * dx))
    v = torch.where(is_y, sy * dz, -dy)
    inv = 1.0 / torch.clamp(ma, min=1e-20)
    uv = (torch.stack([u * inv, v * inv], -1) + 1.0) * 0.5
    return face, uv


def luminance(color):
    return color[..., 0] * 0.2126 + color[..., 1] * 0.7152 + color[..., 2] * 0.0722


def _u32(x):
    return x & M32


def pcg3d(v):
    v = _u32(_u32(v.to(torch.int64) * 1664525) + 1013904223)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = _u32(x + _u32(y * z))
    y = _u32(y + _u32(z * x))
    z = _u32(z + _u32(x * y))
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = _u32(x + _u32(y * z))
    y = _u32(y + _u32(z * x))
    z = _u32(z + _u32(x * y))
    return torch.stack([x, y, z], -1)


def pcg4d(v):
    v = _u32(_u32(v.to(torch.int64) * 1664525) + 1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = _u32(x + _u32(y * w))
    y = _u32(y + _u32(z * x))
    z = _u32(z + _u32(x * y))
    w = _u32(w + _u32(y * z))
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = _u32(x + _u32(y * w))
    y = _u32(y + _u32(z * x))
    z = _u32(z + _u32(x * y))
    w = _u32(w + _u32(y * z))
    return torch.stack([x, y, z, w], -1)


def pt_random(px, py, seed, counter):
    """pcg4d(uint4(pixel, frame seed, counter)) / 0xffffffff as (R, 4) f32;
    seed an (R,) int64 tensor of uint32 values."""
    v = torch.stack([px.to(torch.int64) & M32, py.to(torch.int64) & M32, seed & M32,
                     torch.full_like(seed, int(counter) & M32)], -1)
    return pcg4d(v).to(torch.float32) / _U32_MAX_F


def random_float3(v):
    return pcg3d(v).to(torch.float32) / _U32_MAX_F
