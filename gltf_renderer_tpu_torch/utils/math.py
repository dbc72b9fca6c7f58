"""Core mapping / basis math on torch tensors (vectors on the last axis).

Port of gltf_renderer_tpu/utils/math.py, restricted to what the renderers
and the skinning use. Sums over the last axis are written out term by term in index order,
so the rounding matches the reference's sequential reduction on every device.
"""

from __future__ import annotations

import torch

PI = 3.14159265359
TAU = 2.0 * PI


def trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 of the float tensor x as XLA's convert (the JAX package's
    astype(int32)) gives it: toward zero, saturated to [-2^31, 2^31 - 1],
    NaN to 0. On a CUDA tensor torch's cast is one cvt.rzi.s32.f32, which
    does exactly that. On the CPU torch maps NaN and values at or above 2^31
    to -2^31, so the cast goes through float64, where 2^31 - 1 is exact (in
    float32 it rounds to 2^31, so a clamp in float32 does not work)."""
    if x.is_cuda:
        return x.to(torch.int32)
    return x.double().nan_to_num(0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the (small) last axis as ((x0 + x1) + x2) + ..."""
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
    """MaxValue — Bsdf.hlsli:34-37."""
    return torch.amax(color, dim=-1, keepdim=True)


def sign_not_zero(x):
    """SignNotZero — Common.hlsli:70-76 (>= 0 -> 1 else -1)."""
    return torch.where(x >= 0.0, 1.0, -1.0).to(x.dtype)


def encode_octahedral(n):
    """Unit vector -> [-1, 1]^2 octahedral map (Common.hlsli:78-89)."""
    octa = n / (torch.abs(n[..., 0:1]) + torch.abs(n[..., 1:2]) + torch.abs(n[..., 2:3]))
    xy = octa[..., 0:2]
    folded = sign_not_zero(xy) * (1.0 - torch.abs(octa[..., [1, 0]]))
    return torch.where(octa[..., 2:3] >= 0.0, xy, folded)


def decode_octahedral(e):
    """[-1, 1]^2 -> unit vector (Common.hlsli:91-103)."""
    z = 1.0 - torch.abs(e[..., 0:1]) - torch.abs(e[..., 1:2])
    xy = torch.where(z >= 0.0, e, sign_not_zero(e) * (1.0 - torch.abs(e[..., [1, 0]])))
    return normalize(torch.cat([xy, z], -1))


def create_basis_accurate(n):
    """Duff et al. branchless orthonormal basis (Common.hlsli:46-53)."""
    s = sign_not_zero(n[..., 2:3])
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    b1 = torch.cat([1.0 + s * n[..., 0:1] * n[..., 0:1] * a, s * b, -s * n[..., 0:1]], -1)
    b2 = torch.cat([b, s + n[..., 1:2] * n[..., 1:2] * a, -n[..., 1:2]], -1)
    return b1, b2


def decode_tangent_space(encoded):
    """Normalised float4 of the 10:10:10:2 codec -> (normal, tangent[4])
    (Vertex.hlsli DecodeTangentSpace:5-20): octahedral normal, the tangent
    as an angle in the Duff basis, the winding in .w."""
    normal = decode_octahedral(encoded[..., 0:2] * 2.0 - 1.0)
    ct, cb = create_basis_accurate(normal)
    angle = TAU * encoded[..., 2:3]
    tangent_xyz = torch.cos(angle) * ct + torch.sin(angle) * cb
    tangent_w = torch.where(encoded[..., 3:4] > 0.0, 1.0, -1.0).to(encoded.dtype)
    return normal, torch.cat([tangent_xyz, tangent_w], -1)


def encode_tangent_space(normal, tangent):
    """(normal, tangent[4]) -> the packed 32-bit word, held in an int64
    tensor (Vertex.hlsli EncodeTangentSpace:22-44)."""
    en = 0.5 * encode_octahedral(normal) + 0.5
    qn = trunc_i32(torch.clamp(en, 0.0, 1.0) * 1023.0 + 0.5)
    n2 = decode_octahedral(2.0 * (qn.to(torch.float32) / 1023.0) - 1.0)
    ct, cb = create_basis_accurate(n2)
    angle = torch.atan2(sum_last(tangent[..., 0:3] * cb), sum_last(tangent[..., 0:3] * ct))
    qt = trunc_i32((angle / TAU + 0.5) * 1023.0 + 0.5).to(torch.int64)
    qw = torch.where(tangent[..., 3] == 1.0, 3, 0).to(torch.int64)
    qn = qn.to(torch.int64)
    return qn[..., 0] | (qn[..., 1] << 10) | (qt << 20) | (qw << 30)


def unpack_r10g10b10a2(packed):
    """Packed 32-bit word (int64 tensor) -> normalised float4 (Vertex.hlsli:46-49)."""
    p = packed.to(torch.int64)
    return torch.stack([(p & 0x3FF).to(torch.float32) / 1023.0,
                        ((p >> 10) & 0x3FF).to(torch.float32) / 1023.0,
                        ((p >> 20) & 0x3FF).to(torch.float32) / 1023.0,
                        ((p >> 30) & 0x3).to(torch.float32) / 3.0], -1)


def create_basis(n):
    """Tangent/bitangent for normal n (Common.hlsli CreateBasis:33-42)."""
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
    """HLSL reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * dot(n, i) * n


def uv_to_unit_square(uv):
    """Transforms.hlsli:52-55 — uv*(2,-2)+(-1,1)."""
    return torch.stack([uv[..., 0] * 2.0 + -1.0, uv[..., 1] * -2.0 + 1.0], -1)


def unit_square_to_uv(sq):
    """Transforms.hlsli:57-60."""
    return torch.stack([(sq[..., 0] - -1.0) * 0.5, (sq[..., 1] - 1.0) * -0.5], -1)


def square_to_disk(square):
    """Branchless concentric mapping (Transforms.hlsli SquareToDisk2:82-89)."""
    ax = torch.abs(square[..., 0])
    ay = torch.abs(square[..., 1])
    r = torch.maximum(ax, ay)
    safe_r = torch.where(r == 0, torch.ones_like(r), r)
    phi = torch.where(r == 0.0, torch.zeros_like(r), PI * (r + (ay - ax)) / (4.0 * safe_r))
    x = torch.sign(square[..., 0]) * r * torch.cos(phi)
    y = torch.sign(square[..., 1]) * r * torch.sin(phi)
    return torch.stack([x, y], -1)


def square_to_sphere(square):
    """Octahedral-concentric square->sphere (Transforms.hlsli:125-137)."""
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
    """Inverse of square_to_sphere (Transforms.hlsli:139-150)."""
    z = sphere[..., 2]
    r = torch.sqrt(torch.clamp(1.0 - torch.abs(z), min=0.0))
    phi = torch.atan2(torch.abs(sphere[..., 1]), torch.abs(sphere[..., 0]))
    d = torch.sign(z) * (1.0 - r)
    diff = r * ((4.0 / PI) * phi - 1.0)
    x = torch.sign(sphere[..., 0]) * 0.5 * (1.0 - d - diff)
    y = torch.sign(sphere[..., 1]) * 0.5 * (1.0 - d + diff)
    return torch.stack([x, y], -1)


def direction_to_equirectangular(d):
    """Direction -> equirect uv (Transforms.hlsli:3-8, Z-up)."""
    u = torch.atan2(d[..., 1], d[..., 0]) / TAU
    v = 1.0 - ((d[..., 2] + 1.0) / 2.0)
    return torch.stack([u, v], -1)


def cubemap_to_direction(face, uv):
    """(face, uv in [0,1]^2) -> unit direction (Transforms.hlsli:10-50)."""
    su = uv[..., 0] * 2.0 - 1.0
    sv = uv[..., 1] * 2.0 - 1.0
    one = torch.ones_like(su)

    def pick(c0, c1, c2, c3, c4, c5):
        return torch.where(
            face == 0, c0, torch.where(face == 1, c1, torch.where(
                face == 2, c2, torch.where(face == 3, c3, torch.where(face == 4, c4, c5)))))

    x = pick(one, -one, su, su, su, -su)
    y = pick(-sv, -sv, one, -one, -sv, -sv)
    z = pick(-su, su, sv, -sv, one, -one)
    return normalize(torch.stack([x, y, z], -1))


def direction_to_cubemap(d):
    """Unit direction -> (face, uv) matching cubemap_to_direction."""
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
    """Rec.709 luminance (Color.hlsli:4-7)."""
    return color[..., 0] * 0.2126 + color[..., 1] * 0.7152 + color[..., 2] * 0.0722
