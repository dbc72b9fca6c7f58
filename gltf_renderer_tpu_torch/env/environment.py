"""Environment map: equirect -> cube mips, the GGX- and diffuse-prefiltered
cubes, the luminance importance pyramid and alias table, and the lookups.

Port of gltf_renderer_tpu/env/environment.py (EnvironmentMap.cpp and its
compute shaders). The path tracer reads cube level 0, the importance
pyramid and the alias rows; the raster backend's IBL reads the prefiltered
cubes. The JAX package's quad-packed cubes (`build_cube_quads`) are a TPU
gather layout holding the same texels and are not ported.

`build_environment` is `build_environment_pt` behind the JAX package's npz
disk cache (:512-553), keyed by the equirect's content, shape, the build
sizes and `ENV_CACHE_VERSION`, in `<cache_dir>/env` of a cache root the
caller names (utils/scene_cache.py keeps the scene tables beside it).
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Any, List, NamedTuple

import numpy as np
import torch

from gltf_renderer_tpu_torch.device import resolve
from gltf_renderer_tpu_torch.ops import rng, sampling
from gltf_renderer_tpu_torch.ops.bsdf import ggx_d
from gltf_renderer_tpu_torch.utils.math import (
    PI,
    create_basis,
    cubemap_to_direction,
    direction_to_cubemap,
    direction_to_equirectangular,
    luminance,
    reflect,
    saturate,
    sphere_to_square,
    square_to_sphere,
    sum_last,
    to_world,
    unit_square_to_uv,
    uv_to_unit_square,
)

IMPORTANCE_RESOLUTION = 1024       # EnvironmentMap.cpp:99
DIFFUSE_RESOLUTION = 256           # EnvironmentMap.cpp:114
GGX_SMALLEST_MIP = 4               # EnvironmentMap.cpp:106
ENV_CACHE_VERSION = 1  # bump when a table build_environment_pt makes changes
GGX_SAMPLES, GGX_MIP_BIAS = 256, 2.0          # EnvironmentMap.cpp:395
DIFFUSE_SAMPLES, DIFFUSE_MIP_BIAS = 512, 3.0  # EnvironmentMap.cpp:400


class EnvMaps(NamedTuple):
    """What the renderers read of one environment."""

    cube: List[Any]        # [level 0] — (6, S, S, 3) f32
    importance: List[Any]  # (S, S) luminance-sum pyramid; [-1] is (1, 1)
    equirect: Any          # (H, W, 3) source
    alias_rows: Any        # (S*S, 4) Walker alias rows
    ggx: List[Any] = None  # GGX-prefiltered mips, roughness (i/(n-1))^2
    diffuse: Any = None    # (6, D, D, 3) cosine-convolved cube


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


def _face_pixel_dirs(size: int, device) -> torch.Tensor:
    uv = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    v, u = torch.meshgrid(uv, uv, indexing="ij")  # u = x, v = y
    uv2 = torch.stack([u, v], -1)
    return torch.stack([
        cubemap_to_direction(torch.full(u.shape, f, dtype=torch.int64, device=device), uv2)
        for f in range(6)
    ], 0)


def build_cubemap(equirect, size: int):
    """ConvertEquirectangularToCubemap.cs.hlsl: (6, S, S, 3) cube level 0."""
    dirs = _face_pixel_dirs(size, equirect.device)
    uv = direction_to_equirectangular(dirs)
    uv = torch.stack([torch.remainder(uv[..., 0], 1.0), uv[..., 1]], -1)
    return sample_equirect(equirect, uv)


def build_cube_mips(cube0) -> List[Any]:
    """GenerateMipLevelArray.cs.hlsl: 2x2 box filter down to 1x1."""
    mips = [cube0]
    cur = cube0
    while cur.shape[1] > 1:
        cur = 0.25 * (cur[:, 0::2, 0::2] + cur[:, 1::2, 0::2]
                      + cur[:, 0::2, 1::2] + cur[:, 1::2, 1::2])
        mips.append(cur)
    return mips


def _cube_level_ids(face, uv, s, base_off):
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

    ids = torch.stack([fi(x0, y0), fi(x0 + 1, y0), fi(x0, y0 + 1), fi(x0 + 1, y0 + 1)])
    return ids, tx, ty


def sample_cube_level(faces, direction):
    """Bilinear within one cube level (faces (6, S, S, C)); face-clamped."""
    face, uv = direction_to_cubemap(direction)
    s = faces.shape[1]
    ids, tx, ty = _cube_level_ids(face, uv, s, 0)
    flat = faces.reshape(-1, faces.shape[-1])
    c = flat[ids.reshape(-1)].reshape(ids.shape + (faces.shape[-1],))
    return _bilerp(c[0], c[1], c[2], c[3], tx, ty)


def sample_cube(mips: List[Any], direction, level):
    """Trilinear across a cube mip list; `level` (R,) may be fractional."""
    n = len(mips)
    if n == 1:
        return sample_cube_level(mips[0], direction)
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
        s = sizes[li]
        ids, tx, ty = _cube_level_ids(face, uv, s, offs[li])
        c = flat[ids.reshape(-1)].reshape(ids.shape + (flat.shape[-1],))
        return _bilerp(c[0], c[1], c[2], c[3], tx, ty)

    return level_sample(l0) * (1 - frac) + level_sample(l1) * frac


def build_importance_map(cube_mips: List[Any]) -> List[Any]:
    """GenerateEnvironmentImportanceMap(.Level): luminance of the
    sphere-mapped cube at 1024^2, then a 2x2 SUM pyramid down to 1x1."""
    dev = cube_mips[0].device
    s = IMPORTANCE_RESOLUTION
    uv = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    vy, ux = torch.meshgrid(uv, uv, indexing="ij")
    d = square_to_sphere(uv_to_unit_square(torch.stack([ux, vy], -1)))
    input_width = cube_mips[0].shape[1]
    # GenerateEnvironmentImportanceMap.cs.hlsl:35: log2((6*size)/res) with
    # UNSIGNED INTEGER division before the log2.
    ratio = (6 * input_width) // s
    mip = torch.clamp(torch.log2(torch.tensor(max(ratio, 1e-30), dtype=torch.float32)),
                      0.0, len(cube_mips) - 1)
    color = sample_cube(cube_mips, d, torch.full((s, s), float(mip), device=dev))
    lum = luminance(color)
    mips = [lum]
    cur = lum
    while cur.shape[0] > 1:
        cur = cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
        mips.append(cur)
    return mips


def _filter_cube_level(cube_mips: List[Any], size: int, a: float, num_samples: int,
                       mip_bias: float, bsdf_ggx: bool):
    """One output cube of FilterEnvironmentCubeMap.cs.hlsl: filtered
    importance sampling over the R2 sequence, with the GGX lobe of
    roughness-squared `a` (bsdf_ggx) or the cosine lobe. (6, size, size, 3)."""
    dev = cube_mips[0].device
    n = _face_pixel_dirs(size, dev).reshape(-1, 3)
    t, b = create_basis(n)
    input_width = cube_mips[0].shape[1]
    mip_count = len(cube_mips)
    omega_p = (4.0 * PI) / (6.0 * input_width * input_width)
    a_t = torch.tensor(a, dtype=torch.float32, device=dev)
    start = torch.tensor([0.5, 0.5], dtype=torch.float32, device=dev)
    total = torch.zeros_like(n)
    total_w = torch.zeros(n.shape[0], dtype=torch.float32, device=dev)
    ones = torch.ones_like(total_w)
    for i in range(num_samples):
        u = rng.r2(start, torch.tensor(float(i), device=dev)).expand(n.shape[0], 2)
        if bsdf_ggx:
            h_local = sampling.sample_ggx_normal(a_t, u)
            pdf = ggx_d(a_t, h_local[..., 2]) / 4.0
            l = reflect(-n, to_world(t, b, n, h_local))
            w = saturate(sum_last(n * l))
        else:
            l = sampling.sample_cosine_hemisphere(n, u)
            pdf = sampling.cosine_hemisphere_pdf(n, l)
            w = ones
        omega_s = 1.0 / (num_samples * torch.clamp(pdf, min=1e-20))
        mip = torch.clamp(0.5 * torch.log2(omega_s / omega_p) + mip_bias, 0.0, mip_count - 1)
        total = total + w[..., None] * sample_cube(cube_mips, l, mip)
        total_w = total_w + w
    out = total / torch.clamp(total_w[..., None], min=1e-20)
    return out.reshape(6, size, size, 3)


def build_ggx_cube(cube_mips: List[Any], num_samples: int = GGX_SAMPLES) -> List[Any]:
    """GenerateGgxCube (EnvironmentMap.cpp:393-396): one GGX prefilter per
    mip, roughness-squared a = (mip/(mips-1))^2 (MipToRoughness:17-22);
    mip 0 (a = 0, a mirror) is the source cube itself."""
    size = cube_mips[0].shape[1]
    n_mips = max(int(np.floor(np.log2(size))) + 1 - GGX_SMALLEST_MIP, 1)
    out = [cube_mips[0]]
    for i in range(1, n_mips):
        a = (i / max(n_mips - 1, 1)) ** 2
        out.append(_filter_cube_level(cube_mips, max(size >> i, 1), a, num_samples,
                                      GGX_MIP_BIAS, True))
    return out


def build_diffuse_cube(cube_mips: List[Any], size: int = DIFFUSE_RESOLUTION,
                       num_samples: int = DIFFUSE_SAMPLES):
    """The cosine-convolved irradiance cube (EnvironmentMap.cpp:398-401)."""
    return _filter_cube_level(cube_mips, size, 1.0, num_samples, DIFFUSE_MIP_BIAS, False)


def build_environment_pt(equirect, cube_size: int = None, device="cuda",
                         diffuse_size: int = DIFFUSE_RESOLUTION,
                         prefilters: bool = True) -> EnvMaps:
    """Every environment table, built on `device`: cube level 0, the
    importance pyramid, the alias rows (host-built), the source equirect,
    and the GGX and diffuse prefiltered cubes. diffuse_size is the
    reference's 256 unless a caller (a test) asks for less. With
    prefilters=False the two prefiltered cubes, which only the raster
    backend samples, are not built (ggx [], diffuse None)."""
    dev = resolve(device)
    eq = torch.as_tensor(np.asarray(equirect, np.float32), device=dev)
    if cube_size is None:
        w = eq.shape[1]
        cs = int(max(2 ** int(np.floor(np.log2(max(w // 8, 1)))), 64))
        cs = min(cs, 1024)
    else:
        cs = cube_size
    cube_mips = build_cube_mips(build_cubemap(eq, cs))
    importance = build_importance_map(cube_mips)
    alias_rows = torch.as_tensor(
        sampling.build_alias_rows(importance[0].cpu().numpy()), device=dev)
    if not prefilters:
        return EnvMaps(cube=[cube_mips[0]], importance=importance, equirect=eq,
                       alias_rows=alias_rows, ggx=[], diffuse=None)
    return EnvMaps(cube=[cube_mips[0]], importance=importance, equirect=eq,
                   alias_rows=alias_rows, ggx=build_ggx_cube(cube_mips),
                   diffuse=build_diffuse_cube(cube_mips, size=diffuse_size))


def build_environment(equirect, cube_size: int = None, device="cuda", cache_dir: str = None,
                      diffuse_size: int = DIFFUSE_RESOLUTION,
                      prefilters: bool = True) -> EnvMaps:
    """`build_environment_pt`'s tables, read from the npz cache under the
    cache root `cache_dir` when an entry for these inputs is there, else
    built and stored there. cache_dir None: no cache. A hit gives tensors
    bit-identical to a fresh build, on `device`."""
    dev = resolve(device)
    eq = np.ascontiguousarray(np.asarray(equirect, np.float32))
    if cache_dir is None:
        return build_environment_pt(eq, cube_size, dev, diffuse_size, prefilters)
    key = hashlib.sha1(eq.tobytes() + repr(
        (eq.shape, cube_size, diffuse_size, prefilters, ENV_CACHE_VERSION)).encode()).hexdigest()
    path = os.path.join(cache_dir, "env", f"{key}.npz")
    if os.path.exists(path):
        try:
            return _load_env_npz(path, dev)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            pass  # a torn or stale entry: rebuild it
    env = build_environment_pt(eq, cube_size, dev, diffuse_size, prefilters)
    _save_env_npz(path, env)
    return env


def _save_env_npz(path: str, env: EnvMaps) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {"equirect": env.equirect, "alias_rows": env.alias_rows}
    for field in ("cube", "importance", "ggx"):
        for i, a in enumerate(getattr(env, field) or []):
            arrays[f"{field}_{i}"] = a
    if env.diffuse is not None:
        arrays["diffuse"] = env.diffuse
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **{k: v.cpu().numpy() for k, v in arrays.items()})
    os.replace(tmp, path)


def _load_env_npz(path: str, dev) -> EnvMaps:
    with np.load(path) as z:
        def lst(field):
            out = []
            while f"{field}_{len(out)}" in z:
                out.append(torch.as_tensor(z[f"{field}_{len(out)}"], device=dev))
            return out

        return EnvMaps(cube=lst("cube"), importance=lst("importance"),
                       equirect=torch.as_tensor(z["equirect"], device=dev),
                       alias_rows=torch.as_tensor(z["alias_rows"], device=dev), ggx=lst("ggx"),
                       diffuse=torch.as_tensor(z["diffuse"], device=dev)
                       if "diffuse" in z else None)


def env_radiance(env: EnvMaps, direction):
    """Miss-shader env lookup: cube level 0 (Miss:1040-1042)."""
    return sample_cube_level(env.cube[0], direction)


def env_sample(env: EnvMaps, u4):
    """SampleEnvironmentMap (:688-703) through the alias table. u4 (R, 4).
    Returns (direction, radiance, pdf in solid angle)."""
    size = env.importance[0].shape[0]
    uv, pdf = sampling.sample_importance_alias(env.alias_rows, size,
                                               env.importance[-1][0, 0], u4)
    direction = square_to_sphere(uv_to_unit_square(uv))
    color = sample_cube_level(env.cube[0], direction)
    return direction, color, pdf / (4.0 * PI)


def env_pdf(env: EnvMaps, direction):
    """EnvironmentMapPdf (:705-710)."""
    uv = unit_square_to_uv(sphere_to_square(direction))
    return sampling.importance_map_pdf(env.importance[0].shape[0], env.importance[-1][0, 0],
                                       uv, env.alias_rows) / (4.0 * PI)
