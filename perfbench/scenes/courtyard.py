"""The Sponza-class courtyard: floor, four walls, two rows of eight
pillars, six metal spheres and fourteen alpha-MASKed double-sided banners
(273,856 triangles at density 1) under 25 materials, each with a base
colour, a normal and a metallic-roughness map.

The geometry is a frozen copy of the program's `courtyard_scene` /
`write_courtyard_glb` (the same vertex data, in the same order, and the
root node rotated -90 degrees about X, which the loader's Y-up -> Z-up
basis turns back into the authored Z-up coordinates). Its five groups are
cut into runs of whole parts, one material a run: the floor, each wall,
each pair of pillars, each sphere, and the banners in six runs. The camera
node is left out: the benchmark sets the camera itself.
"""

from __future__ import annotations

import numpy as np

from perfbench.scenes._geometry import REPEAT, concat_parts, cylinder, quad_grid, uv_sphere
from perfbench.scenes._textures import grain, mr_map, normal_map, panels, rgba

# Parts of each group (in the program's order) that share one material.
RUNS = {"floor": [1], "wall": [1, 1, 1, 1], "pillar": [2] * 8, "metal": [1] * 6,
        "banner": [3, 3, 2, 2, 2, 2]}
# (panels a side, base tint range, roughness, metallic) of each group's maps.
LOOK = {"floor": (8, (0.45, 0.75), (0.6, 0.95), 0.0),
        "wall": (16, (0.5, 0.8), (0.7, 0.95), 0.0),
        "pillar": (4, (0.6, 0.9), (0.3, 0.6), 0.0),
        "metal": (2, (0.7, 0.95), (0.1, 0.3), 1.0),
        "banner": (8, (0.2, 0.9), (0.8, 1.0), 0.0)}


def groups(density: int):
    d = density
    g = {k: [] for k in ("floor", "wall", "pillar", "metal", "banner")}
    g["floor"].append(quad_grid([-10, -10, 0], [20, 0, 0], [0, 20, 0], 128 * d, 128 * d))
    for o, au in (([-10, -10, 0], [20, 0, 0]), ([10, 10, 0], [-20, 0, 0]),
                  ([10, -10, 0], [0, 20, 0]), ([-10, 10, 0], [0, -20, 0])):
        g["wall"].append(quad_grid(o, au, [0, 0, 6], 128 * d, 64 * d))
    for y in (-6.0, 6.0):
        for k in range(8):
            g["pillar"].append(cylinder([-8.4 + 2.4 * k, y, 0], 0.35, 5.0, 64 * d, 56 * d))
    for k in range(6):
        p, n, uv, idx = uv_sphere(32 * d, 48 * d, radius=0.5)
        g["metal"].append((p + np.asarray([-7.5 + 3.0 * k, 0.0, 0.8], np.float32), n, uv, idx))
    for k in range(7):
        x = -7.2 + 2.4 * k
        for y in (-6.0, 6.0):
            g["banner"].append(quad_grid([x - 0.8, y, 4.6], [1.6, 0, 0], [0, 0, -2.2],
                                         32 * d, 48 * d))
    return g


def material_maps(group: str, k: int, tex_size: int):
    """[base colour, normal, metallic-roughness] of material k (of `group`);
    banners carry a diamond cutout in the base colour's alpha."""
    rs = np.random.RandomState(11 + k)
    n, (t0, t1), (r0, r1), metal = LOOK[group]
    idx, groove = panels(tex_size, n, max(tex_size // 128, 1))
    cells = n * n
    tint = (t0 + (t1 - t0) * rs.rand(cells, 3)).astype(np.float32)
    rough = (r0 + (r1 - r0) * rs.rand(cells)).astype(np.float32)
    g = grain(rs, tex_size, max(tex_size // 256, 1))
    base = tint[idx] * (0.85 + 0.15 * g[..., None]) * (1.0 - 0.5 * groove[..., None])
    alpha = None
    if group == "banner":
        yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size), indexing="ij")
        p = max(tex_size // 4, 2)
        cx = np.abs((xx % p) - p // 2) + np.abs((yy % p) - p // 2)
        alpha = np.where(cx < 0.625 * p, 1.0, 0.0).astype(np.float32)
    height = 0.5 * (1.0 - groove) + 0.1 * g
    rough_t = np.clip(rough[idx] + 0.1 * (g - 0.5), 0.05, 1.0)
    return [rgba(base, alpha), normal_map(height, 6.0),
            mr_map(rough_t, np.full_like(rough_t, metal))]


def build(density: int = 1, tex_size: int = 1024) -> dict:
    prims, materials, textures = [], [], []
    for group, parts in groups(density).items():
        start = 0
        for count in RUNS[group]:
            m = len(materials)
            p, n, uv, idx = concat_parts(parts[start:start + count])
            start += count
            prims.append(dict(pos=p, normal=n, uv=uv, idx=idx, material=m))
            t = len(textures)
            textures += [dict(image=img, wrap_s=REPEAT, wrap_t=REPEAT)
                         for img in material_maps(group, m, tex_size)]
            mat = dict(base=[1, 1, 1, 1], metallic=1.0, roughness=1.0, albedo=t, normal=t + 1,
                       mr=t + 2, normal_scale=1.0)
            if group == "banner":
                mat.update(mask_cutoff=0.5, double_sided=True)
            materials.append(mat)
        assert start == len(parts), group
    r2 = float(np.sqrt(0.5))
    nodes = [dict(mesh=-1, translation=[0.0, 0.0, 0.0], rotation=[-r2, 0.0, 0.0, r2],
                  children=[1]),
             dict(mesh=0, translation=[0.0, 0.0, 0.0], rotation=[0.0, 0.0, 0.0, 1.0],
                  children=[])]
    return dict(prims=prims, materials=materials, textures=textures, nodes=nodes, roots=[0])
