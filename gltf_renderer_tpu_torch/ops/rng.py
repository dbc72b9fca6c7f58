"""Counter-based RNG: bit-exact pcg3d/pcg4d (Random.hlsli) on torch.

Port of gltf_renderer_tpu/ops/rng.py:20-82 and its R2 sequence (:92). torch has no full uint32
arithmetic on every device, so values ride in int64 and are masked back to
32 bits after every multiply and add; right shifts only ever see masked
(non-negative) values, so they are logical shifts. The streams are identical
to the reference bit for bit, which keeps the path tracer's per-pixel sample
sequence the same as the JAX package's.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_U32_MAX_F = 4294967295.0


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & M32


def pcg3d(v: torch.Tensor) -> torch.Tensor:
    """uint3 hash (Random.hlsli:4-15). v: (..., 3) int64 holding uint32
    values; returns the same."""
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


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """uint4 hash (Random.hlsli:17-30). v: (..., 4) int64 holding uint32
    values; returns the same."""
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


def random_float4(v: torch.Tensor) -> torch.Tensor:
    """4 floats in [0, 1] from a uint4 seed: pcg4d / 0xffffffff in f32."""
    return pcg4d(v).to(torch.float32) / _U32_MAX_F


def pt_random(pixel_x, pixel_y, seed, counter) -> torch.Tensor:
    """pcg4d(uint4(pixel.xy, frame_seed, counter)) as (R, 4) f32.

    seed: int or (R,) int64 tensor of uint32 values; counter: int."""
    px = pixel_x.to(torch.int64)
    seed_t = torch.as_tensor(seed, dtype=torch.int64, device=px.device) & M32
    v = torch.stack([
        px & M32,
        pixel_y.to(torch.int64) & M32,
        torch.broadcast_to(seed_t, px.shape),
        torch.full_like(px, int(counter) & M32),
    ], -1)
    return random_float4(v)


def random_float3(v: torch.Tensor) -> torch.Tensor:
    """3 floats in [0, 1] from a uint3 seed: pcg3d / 0xffffffff in f32."""
    return pcg3d(v).to(torch.float32) / _U32_MAX_F


def r2(start: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Plastic-constant 2D sequence (Random.hlsli:80-85). start (2,) f32,
    n f32 of any shape -> (..., 2) f32 in [0, 1)."""
    g = 1.324717957244746
    a = torch.tensor([1.0 / g, 1.0 / (g * g)], dtype=torch.float32, device=start.device)
    x = start + n.to(torch.float32)[..., None] * a
    return x - torch.floor(x)
