"""Layered glTF BSDF (port of gltf_renderer_tpu/ops/bsdf.py, Bsdf.hlsli).

This slice ports the layers the bench material reaches: anisotropic GGX
specular (evaluated for every material, as in the reference), Lambert
diffuse, the dielectric Fresnel mix and the conductor Fresnel. Sheen,
clearcoat and transmission are not ported yet: `gltf_bsdf` raises if asked
for them, and the port's make_pt_scene refuses scenes that use them.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from gltf_renderer_tpu_torch.utils.math import PI, dot, max_value, normalize, saturate, sum_last, to_local

MINIMUM_ROUGHNESS = 0.001


class SurfaceProperties(NamedTuple):
    """Bsdf.hlsli:4-24. All fields share a batch shape."""

    albedo: Any              # (..., 3)
    alpha: Any               # (..., 1)
    metalness: Any           # (..., 1)
    roughness_squared: Any   # (..., 2) (tangent, bitangent)
    shading_normal: Any      # (..., 3)
    anisotropy_tangent: Any  # (..., 3)
    anisotropy_bitangent: Any  # (..., 3)
    ior: Any                 # (..., 1)
    specular_color: Any      # (..., 3)
    specular_factor: Any     # (..., 1)
    clearcoat: Any           # (..., 1)
    clearcoat_roughness: Any  # (..., 1)
    clearcoat_normal: Any    # (..., 3)
    sheen_color: Any         # (..., 3)
    sheen_roughness_squared: Any  # (..., 1)
    transmissive: Any        # (..., 1)
    thickness: Any           # (..., 1)
    attenuation_distance: Any  # (..., 1)
    attenuation_color: Any   # (..., 3)


def heavyside(a):
    return torch.where(a > 0.0, torch.ones_like(a), torch.zeros_like(a))


def schlick_fresnel(f0, n_dot_v):
    """Bsdf.hlsli:39-47 (uses |n_dot_v|)."""
    return f0 + (1.0 - f0) * torch.pow(1.0 - torch.abs(n_dot_v), 5.0)


def ggx_d(a, n_dot_h):
    a2 = a * a
    num = a2 * heavyside(n_dot_h)
    den = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    den = PI * den * den
    return num / torch.clamp(den, min=1e-20)


def ggx_anisotropic_d(a, h_local):
    """a: (..., 2)."""
    a2 = a[..., 0] * a[..., 1]
    f = torch.stack([a[..., 1] * h_local[..., 0], a[..., 0] * h_local[..., 1],
                     a2 * h_local[..., 2]], -1)
    w2 = a2 / torch.clamp(sum_last(f * f), min=1e-20)
    return heavyside(h_local[..., 2]) * a2 * w2 * w2 / PI


def _aniso_len(a, w_local):
    v = torch.stack([a[..., 0] * w_local[..., 0], a[..., 1] * w_local[..., 1],
                     w_local[..., 2]], -1)
    return torch.sqrt(torch.clamp(sum_last(v * v), min=0.0))


def ggx_anisotropic_correlated_v(a, v_local, l_local, h_dot_v, h_dot_l):
    num = 0.5 * heavyside(h_dot_v) * heavyside(h_dot_l)
    tv = torch.abs(l_local[..., 2]) * _aniso_len(a, v_local)
    tl = torch.abs(v_local[..., 2]) * _aniso_len(a, l_local)
    return num / torch.clamp(tv + tl, min=1e-20)


def anisotropic_specular_brdf(a, v_local, h_local, l_local):
    """Bsdf.hlsli:124-129."""
    h_dot_v = sum_last(h_local * v_local)
    h_dot_l = sum_last(h_local * l_local)
    return ggx_anisotropic_correlated_v(a, v_local, l_local, h_dot_v, h_dot_l) * (
        ggx_anisotropic_d(a, h_local))


def lambert_diffuse(color):
    return color / PI


def fresnel_mix(f0_color, ior, weight, base, layer, h_dot_v):
    """Dielectric specular-over-diffuse (Bsdf.hlsli:136-143)."""
    f0 = (1.0 - ior) / (1.0 + ior)
    f0 = f0 * f0 * f0_color
    f0 = torch.clamp(f0, max=1.0)
    fr = schlick_fresnel(f0, h_dot_v)
    return (1.0 - weight * max_value(fr)) * base + weight * fr * layer


def conductor_fresnel(specular, f0, h_dot_v):
    """Bsdf.hlsli:145-148."""
    return specular * schlick_fresnel(f0, h_dot_v)


def gltf_bsdf(sp: SurfaceProperties, v, l, is_transmission: Optional[torch.Tensor] = None,
              enable_sheen: bool = False, enable_clearcoat: bool = False,
              enable_transmission: bool = False):
    """Layered glTF BSDF (Bsdf.hlsli:241-325) without the sheen, clearcoat
    and transmission layers. With is_transmission (a bool mask) it is the
    reflection/transmission-masked variant."""
    if enable_sheen or enable_clearcoat or enable_transmission:
        raise NotImplementedError("sheen, clearcoat and transmission layers are not ported yet")
    a = sp.roughness_squared
    n = sp.shading_normal
    h = normalize(v + l)
    t, b = sp.anisotropy_tangent, sp.anisotropy_bitangent
    v_local = to_local(t, b, n, v)
    h_local = to_local(t, b, n, h)
    l_local = to_local(t, b, n, l)
    h_dot_v = dot(h, v, keepdims=False)

    l_abs = torch.cat([l_local[..., 0:2], torch.abs(l_local[..., 2:3])], -1)
    h_dot_abs_l = sum_last(normalize(l_abs + v_local) * v_local)

    if is_transmission is None:
        refl_mask = torch.ones_like(l_local[..., 0])
    else:
        refl_mask = torch.where(is_transmission, torch.zeros_like(l_local[..., 0]),
                                torch.ones_like(l_local[..., 0]))
    lz_pos = saturate(l_local[..., 2])
    specular = (refl_mask * lz_pos
                * anisotropic_specular_brdf(a, v_local, h_local, l_local)).unsqueeze(-1)
    diffuse = refl_mask.unsqueeze(-1) * lz_pos.unsqueeze(-1) * lambert_diffuse(sp.albedo)
    dielectric = fresnel_mix(sp.specular_color, sp.ior, sp.specular_factor, diffuse, specular,
                             h_dot_abs_l.unsqueeze(-1))
    metal = refl_mask.unsqueeze(-1) * conductor_fresnel(specular, sp.albedo,
                                                        h_dot_v.unsqueeze(-1))
    return dielectric + sp.metalness * (metal - dielectric)
