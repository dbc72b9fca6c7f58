"""The DamagedHelmet-class sphere: one UV sphere with one material that
carries the asset's five maps (base colour, normal, metallic-roughness,
occlusion, emissive; wrap REPEAT x CLAMP_TO_EDGE).

The sphere is a frozen copy of the program's `textured_sphere_scene`
geometry: one root node, which the loader's Y-up -> Z-up basis turns so
that the sphere's poles lie on the world's Z axis. The maps are panels:
per-panel colour, roughness and metalness, grooves at the seams (dark,
occluded and bent in the normal map), a few glowing panels.
"""

from __future__ import annotations

import numpy as np

from perfbench.scenes._geometry import CLAMP, REPEAT, uv_sphere
from perfbench.scenes._textures import grain, mr_map, normal_map, occlusion_map, panels, rgba

PANELS = 16


def maps(tex_size: int):
    """[base colour, normal, metallic-roughness, occlusion, emissive]."""
    rs = np.random.RandomState(19)
    k = PANELS * PANELS
    tint = (0.25 + 0.6 * rs.rand(k, 3)).astype(np.float32)
    rough = (0.3 + 0.6 * rs.rand(k)).astype(np.float32)
    metal = (rs.rand(k) < 0.4).astype(np.float32)
    glow = rs.rand(k) < 0.06
    glow_col = rs.rand(k, 3).astype(np.float32)
    idx, groove = panels(tex_size, PANELS, max(tex_size // 256, 1))
    g = grain(rs, tex_size, max(tex_size // 512, 1))
    base = tint[idx] * (0.8 + 0.2 * g[..., None]) * (1.0 - 0.6 * groove[..., None])
    height = 0.5 * (1.0 - groove) + 0.05 * g
    rough_t = np.clip(rough[idx] + 0.1 * (g - 0.5), 0.05, 1.0)
    inner = (glow[idx] & (groove == 0.0))[..., None]
    emissive = np.where(inner, glow_col[idx], 0.0).astype(np.float32)
    return [rgba(base), normal_map(height, 8.0), mr_map(rough_t, metal[idx]),
            occlusion_map(1.0 - 0.7 * groove), rgba(emissive)]


def build(tex_size: int = 64, n_lat: int = 16, n_lon: int = 32) -> dict:
    p, n, uv, idx = uv_sphere(n_lat, n_lon)
    material = dict(base=[1, 1, 1, 1], metallic=1.0, roughness=1.0, albedo=0,
                    normal=1, mr=2, occlusion=3, emissive=4, normal_scale=1.0,
                    emissive_factor=[1.0, 1.0, 1.0])
    return dict(
        prims=[dict(pos=p, normal=n, uv=uv, idx=idx, material=0)],
        materials=[material],
        textures=[dict(image=img, wrap_s=REPEAT, wrap_t=CLAMP) for img in maps(tex_size)],
        nodes=[dict(mesh=0, translation=[0.0, 0.0, 0.0], rotation=[0.0, 0.0, 0.0, 1.0],
                    children=[])],
        roots=[0])
