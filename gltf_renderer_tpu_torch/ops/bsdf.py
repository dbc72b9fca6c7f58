"""Layered glTF BSDF (port of gltf_renderer_tpu/ops/bsdf.py, Bsdf.hlsli).

Anisotropic GGX specular (evaluated for every material, as in the
reference), Lambert diffuse, the dielectric Fresnel mix, the conductor
Fresnel, Charlie sheen with the Sheen_E directional-albedo LUT
(data/sheen_e.npy, the table the reference loads from
Resources/Sheen_E.exr), clearcoat, IOR-modulated thin transmission and
Beer's-law attenuation, layered by `gltf_bsdf` (Bsdf.hlsli:241-325).
"""

from __future__ import annotations

import functools
import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from gltf_renderer_tpu_torch.utils.math import (
    PI,
    dot,
    max_value,
    normalize,
    saturate,
    sum_last,
    to_local,
    trunc_i32,
)

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


def ggx_smith_g1(a, n_dot_l, h_dot_l):
    a2 = a * a
    num = 2.0 * n_dot_l * heavyside(h_dot_l)
    den = n_dot_l + torch.sqrt(torch.clamp(a2 + (1.0 - a2) * n_dot_l * n_dot_l, min=0.0))
    return num / torch.clamp(den, min=1e-20)


def ggx_correlated_v(a, n_dot_l, n_dot_v, h_dot_l, h_dot_v):
    a2 = a * a
    num = 0.5 * heavyside(h_dot_l) * heavyside(h_dot_v)
    den = torch.abs(n_dot_v) * torch.sqrt(torch.clamp(a2 + (1.0 - a2) * n_dot_l * n_dot_l,
                                                      min=0.0))
    den = den + torch.abs(n_dot_l) * torch.sqrt(
        torch.clamp(a2 + (1.0 - a2) * n_dot_v * n_dot_v, min=0.0))
    return num / torch.clamp(den, min=1e-20)


def specular_brdf(a, n_dot_l, n_dot_v, n_dot_h, h_dot_l, h_dot_v):
    """Bsdf.hlsli:86-89."""
    return ggx_correlated_v(a, n_dot_l, n_dot_v, h_dot_l, h_dot_v) * ggx_d(a, n_dot_h)


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


def clearcoat_brdf(roughness_squared, n_dot_l, n_dot_v, n_dot_h, h_dot_l, h_dot_v):
    """Bsdf.hlsli:151-154."""
    return specular_brdf(roughness_squared, n_dot_l, n_dot_v, n_dot_h, h_dot_l, h_dot_v)


def fresnel_coat(ior, weight, base, layer, n_dot_v):
    """Bsdf.hlsli:156-162."""
    f0 = (1.0 - ior) / (1.0 + ior)
    f0 = f0 * f0
    fr = schlick_fresnel(f0, n_dot_v)
    w = weight * fr
    return base + (layer - base) * w


# Charlie sheen (Bsdf.hlsli:165-214).

def sheen_normal_distribution(alpha, n_dot_h):
    inv_r = 1.0 / alpha
    cos2 = n_dot_h * n_dot_h
    sin2 = torch.clamp(1.0 - cos2, min=0.0)
    return (2.0 + inv_r) * torch.pow(sin2, inv_r * 0.5) / (2.0 * PI)


def _sheen_l(alpha, x):
    t = (1.0 - alpha) * (1.0 - alpha)
    a = 21.5473 + (25.3245 - 21.5473) * t
    b = 3.82987 + (3.32435 - 3.82987) * t
    c = 0.19823 + (0.16801 - 0.19823) * t
    d = -1.97760 + (-1.27393 + 1.97760) * t
    e = -4.32054 + (-4.85967 + 4.32054) * t
    return a / (1.0 + b * torch.pow(torch.clamp(x, min=1e-20), c)) + d * x + e


def _sheen_shadowing(alpha, cos_theta):
    lo = torch.exp(_sheen_l(alpha, cos_theta))
    hi = torch.exp(2.0 * _sheen_l(alpha, torch.full_like(cos_theta, 0.5))
                   - _sheen_l(alpha, 1.0 - cos_theta))
    return torch.where(cos_theta < 0.5, lo, hi)


def sheen_visibility(alpha, n_dot_l, n_dot_v):
    den = (1.0 + _sheen_shadowing(alpha, n_dot_l) + _sheen_shadowing(alpha, n_dot_v)) * (
        4.0 * n_dot_l * n_dot_v)
    return torch.clamp(1.0 / torch.clamp(den, min=1e-20), 0.0, 1.0)


def sheen_brdf(alpha, n_dot_l, n_dot_v, n_dot_h):
    """Bsdf.hlsli:199-202 (visibility called with (n_dot_v, n_dot_l))."""
    return sheen_normal_distribution(alpha, n_dot_h) * sheen_visibility(alpha, n_dot_v, n_dot_l)


@functools.lru_cache(maxsize=1)
def sheen_e_table() -> np.ndarray:
    """The sheen directional-albedo LUT E(cos_theta, alpha), (16, 16) f32,
    indexed [alpha, cos]: the Dassault Systemes Enterprise PBR table the
    reference loads from Resources/Sheen_E.exr (GpuResources.cpp:72-132),
    kept as data/sheen_e.npy (CC-BY-SA 4.0, data/SHEEN_E_LICENSE.txt)."""
    path = os.path.join(os.path.dirname(__file__), "..", "data", "sheen_e.npy")
    return np.load(path).astype(np.float32)


def sheen_e(alpha, cos_theta, table=None):
    """Bilinear LUT lookup, linear-clamp semantics (Bsdf.hlsli:204-208):
    x = cos_theta, y = alpha, texel centres at (i + 0.5) / N. The floors go
    through trunc_i32, so a NaN lane reads texel 0 as XLA's cast gives it."""
    if table is None:
        table = torch.as_tensor(sheen_e_table(), device=cos_theta.device)
    res_a, res_c = table.shape
    x = torch.clamp(cos_theta * res_c - 0.5, 0.0, res_c - 1.0)
    y = torch.clamp(alpha * res_a - 0.5, 0.0, res_a - 1.0)
    x0 = trunc_i32(torch.floor(x))
    y0 = trunc_i32(torch.floor(y))
    x1 = torch.clamp(x0 + 1, max=res_c - 1)
    y1 = torch.clamp(y0 + 1, max=res_a - 1)
    fx = x - x0
    fy = y - y0
    x0, x1, y0, y1 = x0.long(), x1.long(), y0.long(), y1.long()
    v00 = table[y0, x0]
    v01 = table[y0, x1]
    v10 = table[y1, x0]
    v11 = table[y1, x1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def sheen_mix(material, layer, sheen_color, alpha, n_dot_l, n_dot_v, table=None):
    """Albedo-scaling sheen layering (Bsdf.hlsli:210-214)."""
    mx = max_value(sheen_color)[..., 0]
    scale = torch.minimum(1.0 - mx * sheen_e(alpha, n_dot_v, table),
                          1.0 - mx * sheen_e(alpha, n_dot_l, table))
    return sheen_color * layer.unsqueeze(-1) + material * scale.unsqueeze(-1)


# Transmission and volume (Bsdf.hlsli:216-239).

def modulate_roughness(a, ior):
    """Bsdf.hlsli:216-220."""
    return torch.clamp(a * saturate(2.0 * (ior - 1.0)), MINIMUM_ROUGHNESS, 1.0)


def thin_transmission_btdf(color, a, ior, n, v, l):
    """Thin-surface transmission, GGX about the reflection of l through the
    surface (Bsdf.hlsli:222-228). a, ior: (..., 1)."""
    a = modulate_roughness(a, ior)[..., 0]
    l = l - 2.0 * dot(n, l) * n
    h = normalize(v + l)
    return color * specular_brdf(
        a, dot(n, l, keepdims=False), dot(n, v, keepdims=False), dot(n, h, keepdims=False),
        dot(h, l, keepdims=False), dot(h, v, keepdims=False)).unsqueeze(-1)


def attenuate(attenuation_distance, attenuation_color, distance):
    """Beer's law (Bsdf.hlsli:232-239). attenuation_distance, distance:
    (..., 1); attenuation_color: (..., 3)."""
    expo = distance / torch.clamp(attenuation_distance, min=1e-8)
    att = torch.pow(torch.clamp(attenuation_color, min=1e-8), expo)
    return torch.where(attenuation_distance == 0.0, torch.ones_like(att), att)


def gltf_bsdf(sp: SurfaceProperties, v, l, is_transmission: Optional[torch.Tensor] = None,
              sheen_table=None, enable_sheen: bool = True, enable_clearcoat: bool = True,
              enable_transmission: bool = True):
    """Layered glTF BSDF evaluation: GltfBsdf (Bsdf.hlsli:241-282), or with
    is_transmission (a bool mask) the reflection/transmission-masked variant
    (:284-325). A layer whose flag is off is skipped: the caller turns it
    off only where no material of the scene has it, which gives the same
    value with fewer ops. Returns the (..., 3) BSDF value."""
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

    ones = refl_mask = trans_mask = torch.ones_like(l_local[..., 0])
    if is_transmission is not None:
        zeros = torch.zeros_like(ones)
        refl_mask = torch.where(is_transmission, zeros, ones)
        if enable_transmission:
            trans_mask = torch.where(is_transmission, ones, zeros)
    lz_pos = saturate(l_local[..., 2])
    specular = (refl_mask * lz_pos
                * anisotropic_specular_brdf(a, v_local, h_local, l_local)).unsqueeze(-1)
    diffuse = refl_mask.unsqueeze(-1) * lz_pos.unsqueeze(-1) * lambert_diffuse(sp.albedo)
    if enable_transmission:
        lz_neg = saturate(-l_local[..., 2])
        transmission = trans_mask.unsqueeze(-1) * lz_neg.unsqueeze(-1) * thin_transmission_btdf(
            sp.albedo, a[..., 1:2], sp.ior, n, v, l)
        diffuse = diffuse + sp.transmissive * (transmission - diffuse)
    dielectric = fresnel_mix(sp.specular_color, sp.ior, sp.specular_factor, diffuse, specular,
                             h_dot_abs_l.unsqueeze(-1))
    metal = refl_mask.unsqueeze(-1) * conductor_fresnel(specular, sp.albedo,
                                                        h_dot_v.unsqueeze(-1))
    material = dielectric + sp.metalness * (metal - dielectric)

    if enable_sheen:
        sheen_a = torch.clamp(sp.sheen_roughness_squared[..., 0], 1e-6, 1.0)
        sheen = refl_mask * lz_pos * sheen_brdf(sheen_a, l_local[..., 2], v_local[..., 2],
                                                h_local[..., 2])
        material = sheen_mix(material, sheen, sp.sheen_color, sheen_a, l_local[..., 2],
                             v_local[..., 2], sheen_table)

    if not enable_clearcoat:
        return material
    # Clearcoat evaluation is about the shading normal: the reference's
    # GltfBsdf takes clearcoat_n_dot_{v,h,l} with n = shading_normal
    # (Bsdf.hlsli:275-279, :318-322), while clearcoat sampling, its pdf and
    # the layer probabilities use clearcoat_normal
    # (PathTracer.lib.hlsl:394-411, :540). Kept as the reference has it.
    cn = sp.shading_normal
    cc_n_dot_v = dot(cn, v, keepdims=False)
    cc_n_dot_h = dot(cn, h, keepdims=False)
    cc_n_dot_l = dot(cn, l, keepdims=False)
    h_dot_l = dot(h, l, keepdims=False)
    cc = refl_mask * saturate(cc_n_dot_l) * clearcoat_brdf(
        sp.clearcoat_roughness[..., 0], cc_n_dot_l, cc_n_dot_v, cc_n_dot_h, h_dot_l, h_dot_v)
    return fresnel_coat(1.5, sp.clearcoat, material, cc.unsqueeze(-1), cc_n_dot_v.unsqueeze(-1))
