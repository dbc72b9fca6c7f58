"""The reference path tracer: one sample a pixel, wavefront over a flat
batch of (pixel, frame seed) lanes.

The renderer's semantics, written out plainly for the features the
ToyCar-class scene uses: camera rays jittered by pcg4d(pixel, seed,
counter); closest hits with the alpha-MASK retry (re-cast from just past a
rejected texel, at most MAX_ALPHA_HOPS times); per hit the interpolated
attributes, the surface (base colour, metalness and roughness, each
factor x its map; the normal map's perturbation in the tangent frame, the
shading normal's adaptation, the tangent frame; the IOR; the clearcoat
factor x its map's R, its roughness and its normal, the interpolated
normal adapted; the sheen colour factor x its map, read through the map's
KHR_texture_transform, and its roughness squared; the transmission
factor), the emission at every hit, and the layered glTF BSDF: anisotropic
GGX specular over Lambert, the dielectric Fresnel mix at the material's
IOR, the conductor Fresnel, IOR-modulated thin transmission (GGX about the
reflection of l through the surface) blended in by the transmission
factor, Charlie sheen scaled by the Sheen_E table (its own copy,
sheen_e.npy, CC-BY-SA 4.0: SHEEN_E_LICENSE.txt), and the clearcoat on
top, evaluated about the shading normal (PathTracer.lib.hlsl's GltfBsdf,
Bsdf.hlsli:241-325) while its sample, its pdf and its layer probability
use the clearcoat normal (:394-411, :540); the renderer keeps that quirk
and so does this. Environment NEE with the balance heuristic against the
BSDF's pdf; punctual-light NEE (one light picked uniformly, GetLightRay's
smooth range cutoff over the squared distance and the spot's cone
falloff, Lights.hlsli:26-61) with binary shadow rays out to
MAX_RAY_LENGTH from the surface, at every bounce including the last (the
renderer does that too); the layer probabilities (alpha, clearcoat,
sheen, specular, diffuse, transmission; LayerProbabilities :535-553) and a
BSDF sample by their cumulative thresholds; transmitted bounces leave from
below the surface. Russian roulette from min_bounces on, with the
renderer's rr_state quirk: the throughput that sets the continue
probability is the previous rr_state x the weight, and rr_state becomes
that throughput x the weight after the division (:995-1003). The NaN/Inf
scrub and the luminance clamp. The random counter advances in the
renderer's order: jitter, then per bounce env (bounces before the last),
light (every bounce), BSDF and roulette (before the last).

Every layer is evaluated for every material (the renderer skips a layer
no material of its scene has: the same values). Options the scene does
not use (vertex colours, second UV set, anisotropy, specular maps,
volumes, culling, debug outputs, alpha shadows, directional lights) are
not here. `round_rows_bf16` gives the control: the per-vertex normal,
tangent and UV rounded to bfloat16.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from ..reference import bvh
from ..reference import env as env_ops
from ..reference.common import (
    PI,
    TAU,
    create_basis,
    cross,
    dot,
    luminance,
    max_value,
    normalize,
    pt_random,
    reflect,
    saturate,
    sum_last,
    to_local,
    to_world,
    trunc_i32,
)
from ..reference.pathtracer import (
    LUMINANCE_CLAMP,
    MAX_RAY_LENGTH,
    MINIMUM_ROUGHNESS,
    Hit,
    _aniso_d,
    _balance,
    _corners,
    _cosine_sample,
    _ggx_aniso_sample,
    _heavyside,
    _interp,
    _perturb_normal,
    _schlick,
    _specular,
    base_color,
    camera_rays,
    offset_ray,
    round_rows_bf16,
    shadow,
    texture_slot,
    trace_closest,
)
from .world import MASK, Lights, Materials, Textures, World

CLEARCOAT_IOR = 1.5
RR_MIN, RR_MAX = 0.05, 0.95  # continue-probability clamp
SHEEN_E = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sheen_e.npy")


class Settings(NamedTuple):
    max_bounces: int = 5
    min_bounces: int = 2
    luminance_clamp: bool = True
    env_nee: bool = True      # environment NEE + MIS
    light_nee: bool = True    # punctual-light NEE with binary shadow rays


class Scene(NamedTuple):
    world: World
    tree: bvh.Tree
    materials: Materials
    textures: Textures
    env: env_ops.Env
    has_masked: bool
    lights: Lights
    sheen_e: Any      # (16, 16) f32 [alpha, cos]


# -- textures and surfaces ----------------------------------------------------


def transform_uv(uv, rotation, offset, scale):
    """KHR_texture_transform: scale, then rotate, then offset."""
    su = uv[..., 0] * scale[..., 0]
    sv = uv[..., 1] * scale[..., 1]
    c = torch.cos(rotation)
    s = torch.sin(rotation)
    return torch.stack([c * su + s * sv + offset[..., 0], -s * su + c * sv + offset[..., 1]], -1)


class Surface(NamedTuple):
    albedo: Any
    alpha: Any        # (R, 1)
    metalness: Any    # (R, 1)
    a: Any            # (R, 2) roughness squared (tangent, bitangent)
    n: Any            # shading normal
    t: Any            # anisotropy tangent
    b: Any            # anisotropy bitangent
    ior: Any          # (R, 1)
    spec_color: Any   # (R, 3) KHR_materials_specular's colour: 1
    spec_factor: Any  # (R, 1) and factor: 1
    clearcoat: Any    # (R, 1)
    cc_rough: Any     # (R, 1) clearcoat roughness, at least MINIMUM_ROUGHNESS
    cc_n: Any         # clearcoat normal
    sheen_color: Any  # (R, 3)
    sheen_a: Any      # (R, 1) sheen roughness squared, at least MINIMUM_ROUGHNESS
    transmissive: Any  # (R, 1)


def _adapt(ns, gn, view):
    """Shading-normal adaptation (Iray): a normal that reflects the view
    below the geometric surface is bent back above it."""
    refl = reflect(-view, ns)
    r_dot_ng = dot(refl, gn)
    return torch.where(r_dot_ng < 0.0, normalize(view + normalize(refl - r_dot_ng * gn)), ns)


def surface(scene: Scene, hit: Hit, ray_dir):
    """(Surface, geometric normal, position, emission) at the hits, back
    faces flipped."""
    r0, r1, r2 = _corners(scene, hit.tri)
    u, v = hit.u, hit.v
    w0 = (1.0 - u - v).unsqueeze(-1)
    w1 = u.unsqueeze(-1)
    w2 = v.unsqueeze(-1)
    p0, p1, p2 = r0[:, 0:3], r1[:, 0:3], r2[:, 0:3]
    pos = w0 * p0 + w1 * p1 + w2 * p2
    gn_raw = cross(p1 - p0, p2 - p0)
    gn = normalize(gn_raw)
    normal = normalize(_interp(r0, r1, r2, u, v, 3, 6))
    tangent_xyz = normalize(_interp(r0, r1, r2, u, v, 6, 9))
    tangent_w = r0[:, 9]
    back = dot(gn_raw, ray_dir, keepdims=False) > 0.0
    b3 = back.unsqueeze(-1)
    gn = torch.where(b3, -gn, gn)
    normal = torch.where(b3, -normal, normal)
    tangent_xyz = torch.where(b3, -tangent_xyz, tangent_xyz)
    tangent_w = torch.where(back, -tangent_w, tangent_w).unsqueeze(-1)
    uv = _interp(r0, r1, r2, u, v, 10, 12)
    view = -ray_dir

    mat = scene.world.material[torch.clamp(hit.tri, min=0)]
    base = base_color(scene, mat, uv)
    cut = scene.materials.cutoff[mat]
    a = base[..., 3]
    alpha = torch.where(scene.materials.alpha_mode[mat] == MASK,
                        torch.where(a < cut, torch.zeros_like(a), torch.ones_like(a)),
                        torch.ones_like(a))
    mats = scene.materials
    bitangent = tangent_w * normalize(cross(normal, tangent_xyz))
    nrm_tex, nrm_p = texture_slot(scene, mats.normal, mat, uv)
    ns = _perturb_normal(nrm_tex, nrm_p, mats.normal_scale[mat], normal, tangent_xyz, bitangent)
    ns = _adapt(ns, gn, view)
    # No clearcoat normal map: the interpolated normal, adapted.
    cc_n = _adapt(normal, gn, view)

    mr = texture_slot(scene, mats.mr, mat, uv)[0]
    metalness = mats.metallic[mat] * mr[..., 2]
    rough = mats.roughness[mat] * mr[..., 1]
    rough2 = torch.clamp(rough * rough, min=MINIMUM_ROUGHNESS)
    emission = mats.emissive[mat] * texture_slot(scene, mats.emissive_tex, mat, uv)[0][..., :3]
    clearcoat = mats.clearcoat[mat] * texture_slot(scene, mats.clearcoat_tex, mat, uv)[0][..., 0]
    cc_rough = torch.clamp(mats.clearcoat_roughness[mat], min=MINIMUM_ROUGHNESS)
    rot, off, scl = (x[mat] for x in mats.sheen_xform)
    sheen_uv = transform_uv(uv, rot, off, scl)
    sheen_color = mats.sheen_color[mat] * texture_slot(scene, mats.sheen_tex, mat,
                                                       sheen_uv)[0][..., :3]
    sheen_r = mats.sheen_roughness[mat]
    sheen_a = torch.clamp(sheen_r * sheen_r, min=MINIMUM_ROUGHNESS)
    sb = normalize(cross(ns, tangent_xyz))
    st = normalize(cross(sb, ns))
    sb = sb * tangent_w
    at = normalize(1.0 * st + 0.0 * sb)
    ab = normalize(cross(at, ns))
    ones = torch.ones_like(metalness).unsqueeze(-1)
    return (Surface(albedo=base[..., :3], alpha=alpha.unsqueeze(-1),
                    metalness=metalness.unsqueeze(-1),
                    a=torch.stack([rough2, rough2], -1), n=ns, t=at, b=ab,
                    ior=mats.ior[mat].unsqueeze(-1), spec_color=ones.expand(-1, 3),
                    spec_factor=ones, clearcoat=clearcoat.unsqueeze(-1),
                    cc_rough=cc_rough.unsqueeze(-1), cc_n=cc_n, sheen_color=sheen_color,
                    sheen_a=sheen_a.unsqueeze(-1),
                    transmissive=mats.transmission[mat].unsqueeze(-1)), gn, pos, emission)


# -- the BSDF -----------------------------------------------------------------


def _ggx_d(a, n_dot_h):
    a2 = a * a
    num = a2 * _heavyside(n_dot_h)
    den = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    den = PI * den * den
    return num / torch.clamp(den, min=1e-20)


def _ggx_vis(a, n_dot_l, n_dot_v, h_dot_l, h_dot_v):
    """The height-correlated Smith visibility of isotropic GGX."""
    a2 = a * a
    num = 0.5 * _heavyside(h_dot_l) * _heavyside(h_dot_v)
    den = torch.abs(n_dot_v) * torch.sqrt(torch.clamp(a2 + (1.0 - a2) * n_dot_l * n_dot_l,
                                                      min=0.0))
    den = den + torch.abs(n_dot_l) * torch.sqrt(
        torch.clamp(a2 + (1.0 - a2) * n_dot_v * n_dot_v, min=0.0))
    return num / torch.clamp(den, min=1e-20)


def _ggx(a, n_dot_l, n_dot_v, n_dot_h, h_dot_l, h_dot_v):
    return _ggx_vis(a, n_dot_l, n_dot_v, h_dot_l, h_dot_v) * _ggx_d(a, n_dot_h)


def _modulated_a(a, ior):
    """Transmission roughness: GGX alpha scaled by the IOR's distance from 1."""
    return torch.clamp(a * saturate(2.0 * (ior - 1.0)), MINIMUM_ROUGHNESS, 1.0)


def _thin_btdf(color, a, ior, n, v, l):
    """Thin transmission: GGX about l mirrored through the surface."""
    a = _modulated_a(a, ior)[..., 0]
    l = l - 2.0 * dot(n, l) * n
    h = normalize(v + l)
    return color * _ggx(a, dot(n, l, keepdims=False), dot(n, v, keepdims=False),
                        dot(n, h, keepdims=False), dot(h, l, keepdims=False),
                        dot(h, v, keepdims=False)).unsqueeze(-1)


def _sheen_d(alpha, n_dot_h):
    """Charlie's distribution."""
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


def _sheen_lambda(alpha, cos_theta):
    lo = torch.exp(_sheen_l(alpha, cos_theta))
    hi = torch.exp(2.0 * _sheen_l(alpha, torch.full_like(cos_theta, 0.5))
                   - _sheen_l(alpha, 1.0 - cos_theta))
    return torch.where(cos_theta < 0.5, lo, hi)


def _sheen_vis(alpha, n_dot_l, n_dot_v):
    den = (1.0 + _sheen_lambda(alpha, n_dot_l) + _sheen_lambda(alpha, n_dot_v)) * (
        4.0 * n_dot_l * n_dot_v)
    return torch.clamp(1.0 / torch.clamp(den, min=1e-20), 0.0, 1.0)


def sheen_e(table, alpha, cos_theta):
    """The directional albedo E(cos_theta, alpha): bilinear, clamped to the
    edge texels, texel centres at (i + 0.5) / 16."""
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
    return ((table[y0, x0] * (1 - fx) + table[y0, x1] * fx) * (1 - fy)
            + (table[y1, x0] * (1 - fx) + table[y1, x1] * fx) * fy)


def bsdf(sp: Surface, v, l, is_transmission, table):
    """The layered glTF BSDF. Reflection lanes: specular over diffuse by the
    dielectric Fresnel at the IOR, blended with the conductor by metalness;
    transmission lanes: the thin-transmission lobe in place of the diffuse
    (weighted by the transmission factor) under the same Fresnel. Then the
    sheen, scaled by 1 - max(sheen colour) x E, and the clearcoat's Fresnel
    blend, both on reflection lanes only."""
    h = normalize(v + l)
    v_l = to_local(sp.t, sp.b, sp.n, v)
    h_l = to_local(sp.t, sp.b, sp.n, h)
    l_l = to_local(sp.t, sp.b, sp.n, l)
    h_dot_v = dot(h, v, keepdims=False)
    l_abs = torch.cat([l_l[..., 0:2], torch.abs(l_l[..., 2:3])], -1)
    h_dot_abs_l = sum_last(normalize(l_abs + v_l) * v_l)
    ones = torch.ones_like(l_l[..., 0])
    zeros = torch.zeros_like(ones)
    refl = torch.where(is_transmission, zeros, ones)
    trans = torch.where(is_transmission, ones, zeros)
    lz = saturate(l_l[..., 2])
    spec = (refl * lz * _specular(sp.a, v_l, h_l, l_l)).unsqueeze(-1)
    diffuse = refl.unsqueeze(-1) * lz.unsqueeze(-1) * (sp.albedo / PI)
    lz_neg = saturate(-l_l[..., 2])
    transmission = trans.unsqueeze(-1) * lz_neg.unsqueeze(-1) * _thin_btdf(
        sp.albedo, sp.a[..., 1:2], sp.ior, sp.n, v, l)
    diffuse = diffuse + sp.transmissive * (transmission - diffuse)
    f0 = (1.0 - sp.ior) / (1.0 + sp.ior)
    f0 = torch.clamp(f0 * f0 * sp.spec_color, max=1.0)
    fr = _schlick(f0, h_dot_abs_l.unsqueeze(-1))
    dielectric = (1.0 - sp.spec_factor * max_value(fr)) * diffuse + sp.spec_factor * fr * spec
    metal = refl.unsqueeze(-1) * (spec * _schlick(sp.albedo, h_dot_v.unsqueeze(-1)))
    material = dielectric + sp.metalness * (metal - dielectric)

    sheen_a = torch.clamp(sp.sheen_a[..., 0], 1e-6, 1.0)
    sheen = refl * lz * (_sheen_d(sheen_a, h_l[..., 2])
                         * _sheen_vis(sheen_a, v_l[..., 2], l_l[..., 2]))
    mx = max_value(sp.sheen_color)[..., 0]
    scale = torch.minimum(1.0 - mx * sheen_e(table, sheen_a, v_l[..., 2]),
                          1.0 - mx * sheen_e(table, sheen_a, l_l[..., 2]))
    material = sp.sheen_color * sheen.unsqueeze(-1) + material * scale.unsqueeze(-1)

    cc_n_dot_v = dot(sp.n, v, keepdims=False)
    cc_n_dot_h = dot(sp.n, h, keepdims=False)
    cc_n_dot_l = dot(sp.n, l, keepdims=False)
    h_dot_l = dot(h, l, keepdims=False)
    cc = refl * saturate(cc_n_dot_l) * _ggx(sp.cc_rough[..., 0], cc_n_dot_l, cc_n_dot_v,
                                            cc_n_dot_h, h_dot_l, h_dot_v)
    return _coat(sp.clearcoat, material, cc.unsqueeze(-1), cc_n_dot_v.unsqueeze(-1))


def _coat(weight, base, layer, n_dot_v):
    """The clearcoat's Fresnel blend at IOR 1.5."""
    f0 = (1.0 - CLEARCOAT_IOR) / (1.0 + CLEARCOAT_IOR)
    f0 = f0 * f0
    w = weight * _schlick(f0, n_dot_v)
    return base + (layer - base) * w


class Probs(NamedTuple):
    alpha: Any
    clearcoat: Any
    sheen: Any
    specular: Any
    diffuse: Any
    transmission: Any


def _probs(sp: Surface, v, has_alpha_layer: bool) -> Probs:
    """The layer probabilities: alpha (1 - alpha), then of what remains the
    clearcoat's Fresnel (about the clearcoat normal), half for a sheen,
    half of the rest for the specular, the transmission factor's share of
    the rest, and the diffuse the remainder."""
    zero = torch.zeros_like(sp.alpha[..., 0])
    alpha_p = 1.0 - sp.alpha[..., 0] if has_alpha_layer else zero
    remaining = 1.0 - alpha_p
    fc = _coat(sp.clearcoat, torch.zeros_like(sp.albedo), torch.ones_like(sp.albedo),
               dot(sp.cc_n, v))[..., 0]
    cc_p = fc * remaining
    remaining = remaining - cc_p
    sh_p = torch.where(torch.any(sp.sheen_color > 0.0, -1), 0.5, 0.0) * remaining
    remaining = remaining - sh_p
    spec_p = 0.5 * remaining
    remaining = remaining - spec_p
    tr_p = sp.transmissive[..., 0] * remaining
    remaining = remaining - tr_p
    return Probs(alpha_p, cc_p, sh_p, spec_p, remaining, tr_p)


def _ggx_sample(a, u):
    """An isotropic GGX half vector in the local frame."""
    phi = TAU * u[..., 0]
    u2 = u[..., 1]
    cos_t = torch.sqrt(torch.clamp((1.0 - u2) / (1.0 + (a * a - 1.0) * u2), min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)


def _ggx_pdf(a, n, v, l):
    """pdf of l reflected about a GGX half vector sampled about n."""
    h = normalize(v + l)
    n_dot_h = dot(n, h, keepdims=False)
    return _ggx_d(a, n_dot_h) * n_dot_h / (4.0 * dot(v, h, keepdims=False))


def _pdf(sp: Surface, v, l, is_transmission, probs: Probs):
    cos_pdf = saturate(dot(sp.n, l, keepdims=False) / PI)
    h = normalize(v + l)
    h_l = to_local(sp.t, sp.b, sp.n, h)
    spec_pdf = _aniso_d(sp.a, h_l) * h_l[..., 2] / (4.0 * dot(v, h, keepdims=False))
    refl_pdf = probs.specular * spec_pdf + probs.diffuse * cos_pdf
    refl_pdf = refl_pdf + probs.clearcoat * _ggx_pdf(sp.cc_rough[..., 0], sp.cc_n, v, l)
    refl_pdf = refl_pdf + probs.sheen * cos_pdf
    l_t = l - 2.0 * dot(sp.n, l) * sp.n
    tr_pdf = _ggx_pdf(_modulated_a(sp.a[..., 1], sp.ior[..., 0]), sp.n, v, l_t)
    return torch.where(is_transmission, probs.transmission * tr_pdf, refl_pdf)


def evaluate(sp: Surface, gn, v, l, has_alpha_layer, table):
    is_t = (dot(gn, l, keepdims=False) * dot(gn, v, keepdims=False)) < 0.0
    probs = _probs(sp, v, has_alpha_layer)
    return sp.alpha * bsdf(sp, v, l, is_t, table), _pdf(sp, v, l, is_t, probs)


def sample_bsdf(sp: Surface, u3, v, has_alpha_layer, table):
    """(f, l, pdf, is_transmission, use_mis) of a layered BSDF sample: the
    layer by u3[0] against the cumulative probabilities (alpha, clearcoat,
    sheen, specular, transmission; the rest diffuse), the direction from
    u3[1:3]. Sheen and diffuse sample the cosine lobe."""
    p = _probs(sp, v, has_alpha_layer)
    u = u3[..., 0]
    u2 = u3[..., 1:3]
    c_cc = p.alpha + p.clearcoat
    c_sh = c_cc + p.sheen
    c_sp = c_sh + p.specular
    sel_alpha = u <= p.alpha
    sel_cc = (~sel_alpha) & (u - p.alpha <= p.clearcoat)
    sel_sh = (~sel_alpha) & (~sel_cc) & (u - c_cc <= p.sheen)
    sel_sp = (~sel_alpha) & (~sel_cc) & (~sel_sh) & (u - c_sh <= p.specular)
    sel_tr = (~sel_alpha) & (~sel_cc) & (~sel_sh) & (~sel_sp) & (u - c_sp <= p.transmission)
    l_di = _cosine_sample(sp.n, u2)
    l_sp = reflect(-v, to_world(sp.t, sp.b, sp.n, _ggx_aniso_sample(sp.a, u2)))
    l = torch.where(sel_sp.unsqueeze(-1), l_sp, l_di)
    cc_t, cc_b = create_basis(sp.cc_n)
    l_cc = reflect(-v, to_world(cc_t, cc_b, sp.cc_n, _ggx_sample(sp.cc_rough[..., 0], u2)))
    l = torch.where(sel_cc.unsqueeze(-1), l_cc, l)
    h_tr = to_world(sp.t, sp.b, sp.n,
                    _ggx_sample(_modulated_a(sp.a[..., 1], sp.ior[..., 0]), u2))
    l_tr = reflect(-v, h_tr)
    l_tr = l_tr - 2.0 * dot(sp.n, l_tr) * sp.n
    l = torch.where(sel_tr.unsqueeze(-1), l_tr, l)
    l = torch.where(sel_alpha.unsqueeze(-1), -v, l)
    pdf = _pdf(sp, v, l, sel_tr, p)
    f = sp.alpha * bsdf(sp, v, l, sel_tr, table)
    pdf = torch.where(sel_alpha, p.alpha, pdf)
    f = torch.where(sel_alpha.unsqueeze(-1), 1.0 - sp.alpha, f)
    return f, l, pdf, sel_tr | sel_alpha, ~sel_alpha


# -- punctual lights ----------------------------------------------------------

def sample_light(lights: Lights, pos, u):
    """(direction, radiance, pdf) of one light picked uniformly by u: the
    colour x intensity, for point and spot lights under the range's smooth
    cutoff (1 - (d / range)^4, clamped) over the squared distance, and for
    a spot the square of its linear falloff between the cone angles."""
    n = lights.type.shape[0]
    idx = torch.clamp((u * float(n)).to(torch.int32), 0, n - 1).long()
    kind = lights.type[idx]
    color = lights.color[idx] * lights.intensity[idx].unsqueeze(-1)
    cutoff = lights.cutoff[idx]
    positional = kind != 2
    to_light = torch.where(positional.unsqueeze(-1), lights.position[idx] - pos,
                           -lights.direction[idx])
    dist = torch.sqrt(torch.clamp(sum_last(to_light * to_light), min=1e-20))
    falloff = torch.where(cutoff > 0.0,
                          torch.clamp(1.0 - (dist / torch.clamp(cutoff, min=1e-20)) ** 4, 0.0,
                                      1.0),
                          torch.ones_like(dist))
    falloff = falloff / (dist * dist)
    color = torch.where(positional.unsqueeze(-1), color * falloff.unsqueeze(-1), color)
    direction = normalize(to_light)
    cos_outer = torch.cos(lights.outer[idx])
    scale = 1.0 / torch.clamp(torch.cos(lights.inner[idx]) - cos_outer, min=1e-3)
    offset = -cos_outer * scale
    cd = -sum_last(normalize(lights.direction[idx]) * direction)
    ang = saturate(cd * scale + offset)
    ang = ang * ang
    color = torch.where((kind == 1).unsqueeze(-1), color * ang.unsqueeze(-1), color)
    return direction, color, 1.0 / float(n)


# -- the tracer ---------------------------------------------------------------

def trace(scene: Scene, settings: Settings, c2w, resolution, px, py, seed):
    """(R, 3) radiance of one sample at pixels (px, py) with frame seeds
    `seed` ((R,) int64 of uint32 values)."""
    n_rays = px.shape[0]
    dev = px.device
    counter = 0

    def rand4():
        nonlocal counter
        r = pt_random(px, py, seed, counter)
        counter += 1
        return r

    def full(value):
        return torch.full((n_rays,), value, dtype=torch.float32, device=dev)

    has_alpha_layer = scene.has_masked
    light_nee = settings.light_nee and scene.lights.type.shape[0] > 0
    table = scene.sheen_e
    jitter = rand4()[..., 0:2] - 0.5
    origin, direction_raw = camera_rays(px, py, resolution, c2w, jitter)
    ray_len = torch.sqrt(torch.clamp(sum_last(direction_raw * direction_raw), min=1e-20))
    direction = direction_raw / ray_len.unsqueeze(-1)
    t_max = ray_len
    radiance = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    prefix = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    rr_state = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n_rays, dtype=torch.bool, device=dev)
    prev_pdf = full(0.0)
    prev_mis = torch.zeros(n_rays, dtype=torch.bool, device=dev)
    zero3 = torch.zeros((), dtype=torch.float32, device=dev)

    hit = trace_closest(scene, origin, direction, full(0.0), t_max)
    for bounce in range(settings.max_bounces + 1):
        last = bounce == settings.max_bounces
        miss = alive & (hit.tri < 0)
        d_n = normalize(direction)
        env_col = 1.0 * env_ops.radiance(scene.env, d_n)
        mis_w = torch.where(prev_mis, _balance(prev_pdf, env_ops.pdf(scene.env, d_n)),
                            torch.ones_like(prev_pdf))
        env_col = env_col * mis_w.unsqueeze(-1)
        radiance = radiance + torch.where(miss.unsqueeze(-1), prefix * env_col, zero3)
        alive = alive & (~miss)
        sp, gn, pos, emission = surface(scene, hit, direction)
        radiance = radiance + torch.where(alive.unsqueeze(-1), prefix * emission, zero3)

        view = -direction
        above = offset_ray(pos, gn)
        below = offset_ray(pos, -gn)

        nee = None
        if settings.env_nee and not last:
            l_dir, l_col, l_pdf = env_ops.sample(scene.env, rand4())
            l_col = 1.0 * l_col
            f, f_pdf = evaluate(sp, gn, view, l_dir, has_alpha_layer, table)
            contrib = (_balance(l_pdf, f_pdf).unsqueeze(-1) * f * l_col) / torch.clamp(
                l_pdf.unsqueeze(-1), min=1e-20)
            ok = alive & torch.any(l_col > 0.0, -1)
            nee = (l_dir, torch.where(ok.unsqueeze(-1), prefix * contrib, zero3),
                   ok & torch.any(f > 0.0, -1))

        light = None
        if light_nee:
            # The light is sampled from the point along the ray at the hit's t.
            lit_pos = origin + direction * hit.t.unsqueeze(-1)
            ld, lc, lpdf = sample_light(scene.lights, lit_pos, rand4()[..., 0])
            if last:
                # No bounce to follow: its shadow is cast on its own, from
                # every live lane.
                lc = lc * shadow(scene, above, ld, alive).unsqueeze(-1)
            f, _ = evaluate(sp, gn, view, ld, has_alpha_layer, table)
            ok = alive & torch.any(lc > 0.0, -1)
            contrib = torch.where(ok.unsqueeze(-1), prefix * (lc * f) / lpdf, zero3)
            if last:
                radiance = radiance + contrib
            else:
                light = (ld, contrib, ok & torch.any(f > 0.0, -1))
        if last:
            break

        u3 = rand4()[..., 0:3]
        f, l_dir, pdf, is_t, use_mis = sample_bsdf(sp, u3, view, has_alpha_layer, table)
        weight = torch.where(pdf.unsqueeze(-1) != 0.0, f / pdf.unsqueeze(-1), zero3)
        throughput = rr_state * weight
        u_rr = rand4()[..., 0]
        if bounce >= settings.min_bounces:
            continue_prob = torch.clamp(max_value(throughput)[..., 0], RR_MIN, RR_MAX)
            cont = u_rr < continue_prob
            weight = weight / torch.where(cont, continue_prob,
                                          torch.ones_like(continue_prob)).unsqueeze(-1)
        else:
            cont = torch.ones(n_rays, dtype=torch.bool, device=dev)
        alive = alive & cont & torch.any(throughput > 0.0, -1)
        prefix = prefix * weight
        rr_state = throughput * weight
        origin = torch.where(is_t.unsqueeze(-1), below, above)
        direction = l_dir
        t_max = full(MAX_RAY_LENGTH)
        prev_pdf = pdf
        prev_mis = use_mis

        # The light's shadow, then the environment's, each binary.
        if light is not None:
            radiance = radiance + light[1] * shadow(scene, above, light[0],
                                                    light[2]).unsqueeze(-1)
        if nee is not None:
            radiance = radiance + nee[1] * shadow(scene, above, nee[0], nee[2]).unsqueeze(-1)
        hit = trace_closest(scene, origin, direction, torch.where(alive, full(0.0), t_max + 1.0),
                            t_max)

    nan_mask = torch.any(torch.isnan(radiance), -1)
    inf_mask = torch.any(torch.isinf(radiance), -1)
    radiance = torch.where((nan_mask | inf_mask).unsqueeze(-1), zero3, radiance)
    if settings.luminance_clamp:
        lum = luminance(radiance)
        scale = torch.where(lum > LUMINANCE_CLAMP, LUMINANCE_CLAMP / torch.clamp(lum, min=1e-20),
                            torch.ones_like(lum))
        radiance = radiance * scale.unsqueeze(-1)
    return radiance


def load_sheen_e(device):
    return torch.as_tensor(np.load(SHEEN_E).astype(np.float32), device=device)
