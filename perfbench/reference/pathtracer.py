"""The reference path tracer: one sample a pixel, wavefront over a flat
batch of (pixel, frame seed) lanes.

The renderer's semantics, written out plainly for the features the
benchmark's scenes use: camera rays jittered by pcg4d(pixel, seed,
counter); closest hits with the alpha-MASK retry (re-cast from just past a
rejected texel, at most MAX_ALPHA_HOPS times); per hit the interpolated
attributes, the metallic-roughness surface (base colour, metalness and
roughness, each factor x its map; the normal map's perturbation in the
tangent frame, the shading normal's adaptation, the tangent frame), the
emission (factor x map) at every hit, environment NEE with the
balance heuristic against the layered BSDF's pdf, and a BSDF sample
(the alpha pass-through, GGX specular or the cosine lobe, chosen by the
layer probabilities); binary shadow rays; min_bounces = max_bounces, so no
Russian roulette decides (its draw is still taken); the NaN/Inf scrub and
the luminance clamp. The random counter advances in the renderer's order:
jitter, then per bounce env, BSDF and roulette.

Options the scenes do not use (punctual lights, clearcoat, sheen,
transmission, texture transforms, vertex colours, second UV set, culling,
debug outputs) are not here; occlusion maps serve the raster backend only. `round_rows_bf16` gives the
control: the per-vertex normal, tangent and UV rounded to bfloat16.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from . import bvh
from . import env as env_ops
from .common import (
    PI,
    TAU,
    cross,
    dot,
    luminance,
    max_value,
    normalize,
    pt_random,
    reflect,
    saturate,
    square_to_disk,
    sum_last,
    to_local,
    to_world,
    trunc_i32,
    uv_to_unit_square,
)
from .world import MASK, Materials, Textures, World

MAX_ALPHA_HOPS = 8
MINIMUM_ROUGHNESS = 0.001
MAX_RAY_LENGTH = 1000.0
LUMINANCE_CLAMP = 20.0
IOR = 1.5


class Settings(NamedTuple):
    max_bounces: int = 2
    min_bounces: int = 2
    luminance_clamp: bool = True


class Scene(NamedTuple):
    world: World
    tree: bvh.Tree
    materials: Materials
    textures: Textures
    env: env_ops.Env
    has_masked: bool


def round_rows_bf16(world: World) -> World:
    """The control: normals, tangents and UVs rounded to bfloat16 and back
    (positions stay float32), as hit-attribute rows stored in bf16 give."""
    rows = world.rows.clone()
    rows[:, :, 3:12] = rows[:, :, 3:12].to(torch.bfloat16).to(torch.float32)
    return world._replace(rows=rows)


# -- camera -------------------------------------------------------------------

def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m.astype(np.float32)


def clip_to_world(world_to_view, y_fov: float, aspect: float, z_near: float) -> np.ndarray:
    """Inverse of a reversed-z infinite perspective (far clamped to 1e5)."""
    t = np.tan(0.5 * y_fov)
    n, f = 100000.0, z_near
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = f / (n - f)
    m[2, 3] = -(f * n) / (f - n)
    m[3, 2] = -1.0
    return np.linalg.inv(m @ world_to_view).astype(np.float32)


def camera_rays(px, py, resolution, c2w, jitter):
    w, h = resolution
    cs_x = ((px.to(torch.float32) + 0.5 + jitter[..., 0]) / w) * 2.0 - 1.0
    cs_y = -(((py.to(torch.float32) + 0.5 + jitter[..., 1]) / h) * 2.0 - 1.0)
    ones = torch.ones_like(cs_x)
    zeros = torch.zeros_like(cs_x)
    start = torch.stack([cs_x, cs_y, ones, ones], -1) @ c2w.T
    end = torch.stack([cs_x, cs_y, zeros, ones], -1) @ c2w.T
    origin = start[..., :3] / start[..., 3:4]
    return origin, end[..., :3] / end[..., 3:4] - origin


def offset_ray(position, n):
    """Origin pushed off the surface by integer ulps (Ray Tracing Gems ch. 6)."""
    of_i = (256.0 * n).to(torch.int32)
    pos_i = position.contiguous().view(torch.int32)
    p_i = (pos_i + torch.where(position < 0.0, -of_i, of_i)).view(torch.float32)
    return torch.where(torch.abs(position) < 1.0 / 32.0, position + (1.0 / 65536.0) * n, p_i)


# -- textures and surfaces ----------------------------------------------------

def _wrap(coord, size, mode):
    rep = torch.remainder(coord, size)
    clam = torch.minimum(torch.clamp(coord, min=0), size - 1)
    period = 2 * size
    m = torch.remainder(coord, period)
    mir = torch.where(m >= size, period - 1 - m, m)
    return torch.where(mode == 0, rep, torch.where(mode == 1, clam, mir))


def sample_texture(tex: Textures, tid, uv):
    """Bilinear level-0 fetch of texture `tid` (>= 0) at uv -> (R, 4)."""
    w, h = tex.width[tid], tex.height[tid]
    fx = uv[..., 0] * w.to(torch.float32) - 0.5
    fy = uv[..., 1] * h.to(torch.float32) - 0.5
    x0 = trunc_i32(torch.floor(fx))
    y0 = trunc_i32(torch.floor(fy))
    tx = (fx - x0.to(torch.float32)).unsqueeze(-1)
    ty = (fy - y0.to(torch.float32)).unsqueeze(-1)
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    def fetch(xi, yi):
        i = tex.base[tid] + _wrap(yi, h, tex.wrap_t[tid]) * w + _wrap(xi, w, tex.wrap_s[tid])
        return tex.texels[i].to(torch.float32)

    c00, c10, c01, c11 = fetch(x0, y0), fetch(x0 + 1, y0), fetch(x0, y0 + 1), fetch(x0 + 1, y0 + 1)
    return (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty


def texture_slot(scene: Scene, tex_ids, mat, uv):
    """(texel (R, 4), present (R,) 0/1) of the map `tex_ids[mat]`; where the
    material has none the texel reads 1."""
    tid = tex_ids[mat]
    texel = sample_texture(scene.textures, torch.clamp(tid, min=0), uv)
    presf = (tid >= 0).to(torch.float32).unsqueeze(-1)
    return texel * presf + (1.0 - presf), presf[..., 0]


def base_color(scene: Scene, mat, uv):
    """Base colour factor x texture (RGBA); untextured materials read 1."""
    return scene.materials.base[mat] * texture_slot(scene, scene.materials.albedo, mat, uv)[0]


def _perturb_normal(texel, presf, scale, n, t, b):
    """The normal map's tangent-space normal in the frame (t, b, n)."""
    nm = texel[..., :3] * 2.0 - 1.0
    nm = torch.cat([nm[..., 0:2] * scale.unsqueeze(-1), nm[..., 2:3]], -1)
    mapped = normalize(nm[..., 0:1] * t + nm[..., 1:2] * b + nm[..., 2:3] * n)
    m = presf.unsqueeze(-1)
    return mapped * m + n * (1.0 - m)


class Hit(NamedTuple):
    t: Any
    tri: Any
    u: Any
    v: Any


def _interp(r0, r1, r2, u, v, a, b):
    w0 = (1.0 - u - v).unsqueeze(-1)
    return w0 * r0[:, a:b] + u.unsqueeze(-1) * r1[:, a:b] + v.unsqueeze(-1) * r2[:, a:b]


def _corners(scene: Scene, tri):
    row = scene.world.rows[torch.clamp(tri, min=0)]
    return row[:, 0], row[:, 1], row[:, 2]


def _needs_retry(scene: Scene, hit: Hit):
    r0, r1, r2 = _corners(scene, hit.tri)
    mat = scene.world.material[torch.clamp(hit.tri, min=0)]
    alpha = base_color(scene, mat, _interp(r0, r1, r2, hit.u, hit.v, 10, 12))[..., 3]
    return ((hit.tri >= 0) & (scene.materials.alpha_mode[mat] == MASK)
            & (alpha < scene.materials.cutoff[mat]))


def trace_closest(scene: Scene, origin, direction, t_min, t_max) -> Hit:
    """Closest hit, re-cast past alpha-masked texels below their cutoff."""
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=origin.device), t_min.shape)
    hit = Hit(*bvh.cast(scene.tree, origin, direction, t_min, t_max))
    if not scene.has_masked:
        return hit
    tmin_cur = t_min
    need = _needs_retry(scene, hit)
    for _ in range(MAX_ALPHA_HOPS):
        if not bool(need.any()):
            break
        tmin_cur = torch.where(need, hit.t * (1.0 + 1e-5) + 1e-6, tmin_cur)
        idx = torch.nonzero(need).squeeze(1)
        nh = Hit(*bvh.cast(scene.tree, origin[idx], direction[idx], tmin_cur[idx], t_max[idx]))
        hit = Hit(*(c.index_put((idx,), n) for c, n in zip(hit, nh)))
        need = _needs_retry(scene, hit) & need
    return hit


def shadow(scene: Scene, origin, direction, active):
    """1 where the segment (0, MAX_RAY_LENGTH) meets no triangle, else 0
    (binary: alpha-masked texels occlude); inactive rays cast nothing."""
    t_max = torch.full(active.shape, MAX_RAY_LENGTH, dtype=torch.float32, device=origin.device)
    t_min = torch.where(active, torch.zeros_like(t_max), t_max + 1.0)
    return (bvh.cast(scene.tree, origin, direction, t_min, t_max, any_hit=True)[1] < 0).to(
        torch.float32)


class Surface(NamedTuple):
    albedo: Any
    alpha: Any        # (R, 1)
    metalness: Any    # (R, 1)
    a: Any            # (R, 2) roughness squared (tangent, bitangent)
    n: Any            # shading normal
    t: Any            # anisotropy tangent
    b: Any            # anisotropy bitangent


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
    # Shading-normal adaptation (Iray): a normal that reflects the view
    # below the geometric surface is bent back above it.
    refl = reflect(-view, ns)
    r_dot_ng = dot(refl, gn)
    ns = torch.where(r_dot_ng < 0.0, normalize(view + normalize(refl - r_dot_ng * gn)), ns)

    mr = texture_slot(scene, mats.mr, mat, uv)[0]
    metalness = mats.metallic[mat] * mr[..., 2]
    rough = mats.roughness[mat] * mr[..., 1]
    rough2 = torch.clamp(rough * rough, min=MINIMUM_ROUGHNESS)
    emission = mats.emissive[mat] * texture_slot(scene, mats.emissive_tex, mat, uv)[0][..., :3]
    sb = normalize(cross(ns, tangent_xyz))
    st = normalize(cross(sb, ns))
    sb = sb * tangent_w
    at = normalize(1.0 * st + 0.0 * sb)
    ab = normalize(cross(at, ns))
    return (Surface(albedo=base[..., :3], alpha=alpha.unsqueeze(-1),
                    metalness=metalness.unsqueeze(-1),
                    a=torch.stack([rough2, rough2], -1), n=ns, t=at, b=ab), gn, pos, emission)


# -- the BSDF -----------------------------------------------------------------

def _heavyside(x):
    return torch.where(x > 0.0, torch.ones_like(x), torch.zeros_like(x))


def _aniso_d(a, h):
    a2 = a[..., 0] * a[..., 1]
    f = torch.stack([a[..., 1] * h[..., 0], a[..., 0] * h[..., 1], a2 * h[..., 2]], -1)
    w2 = a2 / torch.clamp(sum_last(f * f), min=1e-20)
    return _heavyside(h[..., 2]) * a2 * w2 * w2 / PI


def _aniso_len(a, w):
    v = torch.stack([a[..., 0] * w[..., 0], a[..., 1] * w[..., 1], w[..., 2]], -1)
    return torch.sqrt(torch.clamp(sum_last(v * v), min=0.0))


def _specular(a, v, h, l):
    h_dot_v = sum_last(h * v)
    h_dot_l = sum_last(h * l)
    num = 0.5 * _heavyside(h_dot_v) * _heavyside(h_dot_l)
    vis = num / torch.clamp(torch.abs(l[..., 2]) * _aniso_len(a, v)
                            + torch.abs(v[..., 2]) * _aniso_len(a, l), min=1e-20)
    return vis * _aniso_d(a, h)


def _schlick(f0, n_dot_v):
    return f0 + (1.0 - f0) * torch.pow(1.0 - torch.abs(n_dot_v), 5.0)


def bsdf(sp: Surface, v, l, is_transmission):
    """Dielectric (specular over Lambert, Schlick at ior 1.5) blended with
    the conductor by metalness; transmission lanes read 0."""
    h = normalize(v + l)
    v_l = to_local(sp.t, sp.b, sp.n, v)
    h_l = to_local(sp.t, sp.b, sp.n, h)
    l_l = to_local(sp.t, sp.b, sp.n, l)
    h_dot_v = dot(h, v, keepdims=False)
    l_abs = torch.cat([l_l[..., 0:2], torch.abs(l_l[..., 2:3])], -1)
    h_dot_abs_l = sum_last(normalize(l_abs + v_l) * v_l)
    ones = torch.ones_like(l_l[..., 0])
    refl = torch.where(is_transmission, torch.zeros_like(ones), ones)
    lz = saturate(l_l[..., 2])
    spec = (refl * lz * _specular(sp.a, v_l, h_l, l_l)).unsqueeze(-1)
    diffuse = refl.unsqueeze(-1) * lz.unsqueeze(-1) * (sp.albedo / PI)
    f0 = (1.0 - torch.full_like(sp.metalness, IOR)) / (1.0 + torch.full_like(sp.metalness, IOR))
    f0 = torch.clamp(f0 * f0 * torch.ones_like(sp.albedo), max=1.0)
    fr = _schlick(f0, h_dot_abs_l.unsqueeze(-1))
    dielectric = (1.0 - 1.0 * max_value(fr)) * diffuse + 1.0 * fr * spec
    metal = refl.unsqueeze(-1) * (spec * _schlick(sp.albedo, h_dot_v.unsqueeze(-1)))
    return dielectric + sp.metalness * (metal - dielectric)


def _probs(sp: Surface, has_alpha_layer: bool):
    """(alpha, specular, diffuse) layer probabilities."""
    zero = torch.zeros_like(sp.alpha[..., 0])
    alpha_p = 1.0 - sp.alpha[..., 0] if has_alpha_layer else zero
    remaining = 1.0 - alpha_p
    spec_p = 0.5 * remaining
    return alpha_p, spec_p, remaining - spec_p


def _ggx_aniso_sample(a, u):
    d = square_to_disk(uv_to_unit_square(u))
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    hl = torch.cat([d, z.unsqueeze(-1)], -1)
    return normalize(torch.cat([hl[..., 0:2] * a, hl[..., 2:3]], -1))


def _cosine_sample(n, u):
    theta = TAU * u[..., 0]
    y = 2.0 * u[..., 1] - 1.0
    s = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    return normalize(n + torch.stack([s * torch.cos(theta), s * torch.sin(theta), y], -1))


def _pdf(sp: Surface, v, l, probs):
    _, spec_p, diff_p = probs
    cos_pdf = saturate(dot(sp.n, l, keepdims=False) / PI)
    h = normalize(v + l)
    spec_pdf = (_aniso_d(sp.a, to_local(sp.t, sp.b, sp.n, h)) * to_local(sp.t, sp.b, sp.n, h)[..., 2]
                / (4.0 * dot(v, h, keepdims=False)))
    return spec_p * spec_pdf + diff_p * cos_pdf


def evaluate(sp: Surface, gn, v, l, has_alpha_layer):
    is_t = (dot(gn, l, keepdims=False) * dot(gn, v, keepdims=False)) < 0.0
    return sp.alpha * bsdf(sp, v, l, is_t), _pdf(sp, v, l, _probs(sp, has_alpha_layer))


def sample_bsdf(sp: Surface, u3, v, has_alpha_layer):
    """(f, l, pdf, is_transmission, use_mis) of a layered BSDF sample."""
    probs = _probs(sp, has_alpha_layer)
    alpha_p, spec_p, _ = probs
    u = u3[..., 0]
    u2 = u3[..., 1:3]
    sel_alpha = u <= alpha_p
    sel_sp = (~sel_alpha) & (u - alpha_p <= spec_p)
    l_di = _cosine_sample(sp.n, u2)
    l_sp = reflect(-v, to_world(sp.t, sp.b, sp.n, _ggx_aniso_sample(sp.a, u2)))
    l = torch.where(sel_sp.unsqueeze(-1), l_sp, l_di)
    l = torch.where(sel_alpha.unsqueeze(-1), -v, l)
    no_t = torch.zeros_like(sel_alpha)
    pdf = torch.where(sel_alpha, alpha_p, _pdf(sp, v, l, probs))
    f = torch.where(sel_alpha.unsqueeze(-1), 1.0 - sp.alpha, sp.alpha * bsdf(sp, v, l, no_t))
    return f, l, pdf, sel_alpha, ~sel_alpha


def _balance(pdf, other):
    return pdf / torch.clamp(pdf + other, min=1e-20)


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
        if bounce == settings.max_bounces:
            break

        view = -direction
        above = offset_ray(pos, gn)
        below = offset_ray(pos, -gn)

        l_dir, l_col, l_pdf = env_ops.sample(scene.env, rand4())
        l_col = 1.0 * l_col
        f, f_pdf = evaluate(sp, gn, view, l_dir, has_alpha_layer)
        contrib = (_balance(l_pdf, f_pdf).unsqueeze(-1) * f * l_col) / torch.clamp(
            l_pdf.unsqueeze(-1), min=1e-20)
        ok = alive & torch.any(l_col > 0.0, -1)
        s_active = ok & torch.any(f > 0.0, -1)
        nee = torch.where(ok.unsqueeze(-1), prefix * contrib, zero3)
        nee_dir = l_dir

        u3 = rand4()[..., 0:3]
        f, l_dir, pdf, is_t, use_mis = sample_bsdf(sp, u3, view, has_alpha_layer)
        weight = torch.where(pdf.unsqueeze(-1) != 0.0, f / pdf.unsqueeze(-1), zero3)
        throughput = rr_state * weight
        u_rr = rand4()[..., 0]
        if bounce >= settings.min_bounces:
            continue_prob = torch.clamp(max_value(throughput)[..., 0], 0.05, 0.95)
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

        radiance = radiance + nee * shadow(scene, above, nee_dir, s_active).unsqueeze(-1)
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
