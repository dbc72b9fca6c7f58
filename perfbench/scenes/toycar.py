"""The ToyCar-class product shot: a toy car on a fabric plinth before a
curved fabric backdrop, under a studio key (point) and fill (spot) light
and the open sky.

The car: a clearcoated painted body (a superellipsoid), a thin
transmissive glass canopy (double-sided, IOR 1.5) over two fabric seats,
four rubber tyres (tori) on chrome hubs. Five materials, as the asset's set
in kind:

  0 body    base colour, normal and metallic-roughness maps,
            KHR_materials_clearcoat with a clearcoat map
  1 fabric  base colour and normal maps, KHR_materials_sheen with a
            sheen-colour map tiled 8 x 8 by KHR_texture_transform
  2 glass   KHR_materials_transmission (1.0) and KHR_materials_ior (1.5)
  3 chrome  metallic 1, roughness 0.08, no maps
  4 tyres   base colour, normal and metallic-roughness maps

The geometry is authored Z up under a root node rotated -90 degrees about
X, which the loader's Y-up -> Z-up basis turns back; the two light nodes
are children of that root. Maps are (S, S, 4) u8 panels from
perfbench.scenes._textures.
"""

from __future__ import annotations

import numpy as np

from perfbench.scenes._geometry import REPEAT, concat_parts, grid_idx, quad_grid
from perfbench.scenes._textures import grain, mr_map, normal_map, panels, rgba

BODY, FABRIC, GLASS, CHROME, TYRES = range(5)
SHEEN_TILING = 8.0
PLINTH_TOP = 0.0
WHEEL_R, TYRE_R = 0.17, 0.065  # torus major and minor radius
WHEEL_Z = PLINTH_TOP + WHEEL_R + TYRE_R
BODY_C = (0.0, 0.0, WHEEL_Z + 0.17)
BODY_AXES = (0.82, 0.36, 0.2)
WHEEL_Y = 0.4


def _param_grid(fn, nu, nv, wrap_u=False):
    """Vertices fn(u, v) over an (nu [+1]) x (nv + 1) grid of u, v in
    [0, 1]; with wrap_u the last u column is the first (a closed loop)."""
    us = np.linspace(0.0, 1.0, nu + 1)[:nu] if wrap_u else np.linspace(0.0, 1.0, nu + 1)
    vs = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    p = np.asarray(fn(uu, vv), np.float64)
    uv = np.stack([uu, vv], -1)
    if wrap_u:
        i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
        a = i * (nv + 1) + j
        b = ((i + 1) % nu) * (nv + 1) + j
        idx = np.stack([a, b, b + 1, a, b + 1, a + 1], -1).reshape(-1).astype(np.uint32)
    else:
        idx = grid_idx(nu, nv)
    return p.reshape(-1, 3), uv.reshape(-1, 2), idx


def _vertex_normals(pos, idx):
    """Area-weighted vertex normals of an indexed triangle list (the
    counter-clockwise side)."""
    tri = idx.reshape(-1, 3)
    p0, p1, p2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    n = np.zeros_like(pos)
    for k in range(3):
        np.add.at(n, tri[:, k], fn)
    length = np.linalg.norm(n, axis=-1, keepdims=True)
    fallback = np.broadcast_to(np.asarray([0.0, 0.0, 1.0]), n.shape)
    return np.where(length > 1e-12, n / np.maximum(length, 1e-30), fallback)


def _part(fn, nu, nv, wrap_u=False, flip=False):
    """A surface's part with vertex normals from its winding; `flip`
    reverses the winding (the grid's own faces the -u x v side)."""
    p, uv, idx = _param_grid(fn, nu, nv, wrap_u)
    if flip:
        idx = _reverse(idx)
    n = _vertex_normals(p, idx)
    return p.astype(np.float32), n.astype(np.float32), uv.astype(np.float32), idx


def _reverse(idx):
    return idx.reshape(-1, 3)[:, [0, 2, 1]].reshape(-1).astype(np.uint32)


def _spow(w, e):
    return np.sign(w) * np.abs(w) ** e


def superellipsoid(center, axes, e_lat, e_lon, n_lat, n_lon, lat_max=np.pi):
    """A superellipsoid (uv-sphere topology; lat from +Z down to lat_max)."""
    cx, cy, cz = center
    a, b, c = axes

    def fn(u, v):
        phi = 2.0 * np.pi * u
        th = lat_max * v
        s, ct = np.sin(th), np.cos(th)
        return np.stack([cx + a * _spow(s, e_lat) * _spow(np.cos(phi), e_lon),
                         cy + b * _spow(s, e_lat) * _spow(np.sin(phi), e_lon),
                         cz + c * _spow(ct, e_lat)], -1)

    return _part(fn, n_lon, n_lat, wrap_u=True, flip=True)


def torus(center, major, minor, n_major, n_minor):
    """A torus about the Y axis (a tyre on an axle along Y)."""
    cx, cy, cz = center

    def fn(u, v):
        a = 2.0 * np.pi * u
        b = 2.0 * np.pi * v
        r = major + minor * np.cos(b)
        return np.stack([cx + r * np.cos(a), cy + minor * np.sin(b), cz + r * np.sin(a)], -1)

    p, uv, idx = _param_grid(fn, n_major, n_minor, wrap_u=True)
    # The minor loop's last row repeats its first (a seam, so that the map
    # wraps); normals from the analytic surface, outward.
    a = 2.0 * np.pi * uv[:, 0]
    b = 2.0 * np.pi * uv[:, 1]
    n = np.stack([np.cos(b) * np.cos(a), np.sin(b), np.cos(b) * np.sin(a)], -1)
    return p.astype(np.float32), n.astype(np.float32), uv.astype(np.float32), _reverse(idx)


def backdrop(radius, cove, height, theta0, theta1, n_u, n_v):
    """A curved studio backdrop (cyclorama): from the floor at `radius`
    around the origin, a cove of radius `cove` up into a wall `height`
    tall, over the angles theta0..theta1; faces the origin."""
    arc = 0.5 * np.pi * cove
    run = arc + height - cove

    def fn(u, v):
        th = theta0 + (theta1 - theta0) * u
        s = v * run
        in_cove = s < arc
        ang = np.where(in_cove, s / cove, 0.5 * np.pi)
        r = np.where(in_cove, radius + cove * np.sin(ang), radius + cove)
        z = np.where(in_cove, cove * (1.0 - np.cos(ang)), cove + (s - arc))
        return np.stack([r * np.cos(th), r * np.sin(th), PLINTH_TOP - 0.3 + z], -1)

    return _part(fn, n_u, n_v, flip=True)


def _flip(part):
    p, n, uv, idx = part
    return p, -n, uv, _reverse(idx)


def parts(scale: int = 1):
    """{material: [(pos, normal, uv, idx), ...]} of the whole set; `scale`
    divides every tessellation (tests use a coarse set)."""
    d = max(int(scale), 1)
    g = {m: [] for m in range(5)}
    g[BODY].append(superellipsoid(BODY_C, BODY_AXES, 0.6, 0.35, 160 // d, 320 // d))
    cz = BODY_C[2] + 0.8 * BODY_AXES[2]
    g[GLASS].append(superellipsoid((-0.08, 0.0, cz), (0.34, 0.27, 0.2), 1.0, 0.8,
                                   48 // d, 128 // d, lat_max=0.5 * np.pi))
    for y in (-0.11, 0.11):
        g[FABRIC].append(superellipsoid((-0.1, y, cz + 0.02), (0.09, 0.08, 0.09), 0.8, 0.8,
                                        24 // d, 48 // d))
    for x in (-0.5, 0.5):
        for y in (-WHEEL_Y, WHEEL_Y):
            g[TYRES].append(torus((x, y, WHEEL_Z), WHEEL_R, TYRE_R, 96 // d, 48 // d))
            g[CHROME].append(superellipsoid((x, y, WHEEL_Z), (WHEEL_R, 0.045, WHEEL_R), 1.0,
                                            1.0, 16 // d, 32 // d))
    # The plinth (a square slab) and the floor and backdrop behind it.
    h = 1.6
    g[FABRIC].append(quad_grid([-h, -h, PLINTH_TOP], [2 * h, 0, 0], [0, 2 * h, 0],
                               64 // d, 64 // d))
    for o, au in (([-h, -h, PLINTH_TOP], [2 * h, 0, 0]), ([h, h, PLINTH_TOP], [-2 * h, 0, 0]),
                  ([h, -h, PLINTH_TOP], [0, 2 * h, 0]), ([-h, h, PLINTH_TOP], [0, -2 * h, 0])):
        g[FABRIC].append(_flip(quad_grid(o, au, [0, 0, -0.3], 64 // d, 4)))
    g[FABRIC].append(quad_grid([-9, -9, PLINTH_TOP - 0.3], [18, 0, 0], [0, 18, 0],
                               32 // d, 32 // d))
    g[FABRIC].append(backdrop(5.0, 1.5, 6.0, np.radians(15.0), np.radians(255.0),
                              128 // d, 24 // d))
    return g


def maps(tex_size: int):
    """[body base colour, normal, metallic-roughness, clearcoat;
    fabric base colour, normal, sheen colour; tyre base colour, normal,
    metallic-roughness]."""
    rs = np.random.RandomState(23)
    s = tex_size
    # Body: lacquered red panels, fine orange peel, a metal flake base.
    idx, groove = panels(s, 4, max(s // 128, 1))
    g = grain(rs, s, max(s // 512, 1))
    tint = np.asarray([0.62, 0.05, 0.04], np.float32) * (0.9 + 0.1 * rs.rand(16, 1)).astype(
        np.float32)
    body_base = tint[idx] * (0.92 + 0.08 * g[..., None]) * (1.0 - 0.5 * groove[..., None])
    body_h = 0.5 * (1.0 - groove) + 0.02 * g
    body_mr = mr_map(np.clip(0.35 + 0.1 * (g - 0.5), 0.05, 1.0), np.full_like(g, 0.3))
    coat = np.clip(1.0 - 0.6 * groove, 0.0, 1.0)
    body_cc = rgba(np.stack([coat, coat, coat], -1))
    # Fabric: a weave of small cells; its sheen a cool tint a cell.
    nw = min(32, s // 2)
    widx, wgroove = panels(s, nw, max(s // 256, 1))
    wg = grain(rs, s, max(s // 256, 1))
    wtint = (np.asarray([0.16, 0.18, 0.24], np.float32)
             * (0.8 + 0.4 * rs.rand(nw * nw, 1)).astype(np.float32))
    fab_base = wtint[widx] * (0.85 + 0.15 * wg[..., None]) * (1.0 - 0.3 * wgroove[..., None])
    fab_h = 0.5 * (1.0 - wgroove) + 0.1 * wg
    sidx, _ = panels(s, 16, 1)
    sheen = (0.45 + 0.35 * rs.rand(16 * 16, 3)).astype(np.float32)[sidx]
    # Tyres: dark rubber with tread grooves.
    _, tgroove = panels(s, 16, max(s // 128, 1))
    tg = grain(rs, s, max(s // 512, 1))
    tyre_base = np.full((s, s, 3), 0.05, np.float32) * (0.8 + 0.4 * tg[..., None])
    tyre_h = 0.5 * (1.0 - tgroove) + 0.05 * tg
    tyre_mr = mr_map(np.clip(0.85 + 0.1 * (tg - 0.5), 0.05, 1.0), np.zeros_like(tg))
    return [rgba(body_base), normal_map(body_h, 2.0), body_mr, body_cc,
            rgba(fab_base), normal_map(fab_h, 4.0), rgba(sheen),
            rgba(tyre_base), normal_map(tyre_h, 6.0), tyre_mr]


def _look_quat(direction):
    """xyzw rotation taking the light's -Z axis onto `direction`."""
    a = np.asarray([0.0, 0.0, -1.0])
    b = np.asarray(direction, np.float64)
    b = b / np.linalg.norm(b)
    q = np.concatenate([np.cross(a, b), [1.0 + float(a @ b)]])
    return (q / np.linalg.norm(q)).tolist()


LIGHTS = [
    {"type": "point", "color": [1.0, 0.92, 0.82], "intensity": 30.0, "range": 12.0},
    {"type": "spot", "color": [0.75, 0.85, 1.0], "intensity": 60.0, "range": 14.0,
     "spot": {"innerConeAngle": 0.3, "outerConeAngle": 0.6}},
]
KEY_POS = [1.6, -1.4, 2.0]
FILL_POS = [-1.4, -2.6, 2.2]


def build(tex_size: int = 1024, scale: int = 1) -> dict:
    prims = []
    for m, ps in parts(scale).items():
        p, n, uv, idx = concat_parts(ps)
        prims.append(dict(pos=p, normal=n, uv=uv, idx=idx, material=m))
    textures = [dict(image=img, wrap_s=REPEAT, wrap_t=REPEAT) for img in maps(tex_size)]
    sheen_info = {"index": 6, "extensions": {"KHR_texture_transform": {
        "scale": [SHEEN_TILING, SHEEN_TILING]}}}
    materials = [
        dict(base=[1, 1, 1, 1], metallic=1.0, roughness=1.0, albedo=0, normal=1, mr=2,
             normal_scale=1.0, extensions={"KHR_materials_clearcoat": {
                 "clearcoatFactor": 1.0, "clearcoatRoughnessFactor": 0.06,
                 "clearcoatTexture": {"index": 3}}}),
        dict(base=[1, 1, 1, 1], metallic=0.0, roughness=0.9, albedo=4, normal=5,
             normal_scale=1.0, extensions={"KHR_materials_sheen": {
                 "sheenColorFactor": [1.0, 1.0, 1.0], "sheenRoughnessFactor": 0.5,
                 "sheenColorTexture": sheen_info}}),
        dict(base=[1.0, 1.0, 1.0, 1.0], metallic=0.0, roughness=0.05, double_sided=True,
             extensions={"KHR_materials_transmission": {"transmissionFactor": 1.0},
                         "KHR_materials_ior": {"ior": 1.5}}),
        dict(base=[0.95, 0.95, 0.97, 1.0], metallic=1.0, roughness=0.08),
        dict(base=[1, 1, 1, 1], metallic=1.0, roughness=1.0, albedo=7, normal=8, mr=9,
             normal_scale=1.0),
    ]
    r2 = float(np.sqrt(0.5))
    target = np.asarray([0.0, 0.0, BODY_C[2]])
    nodes = [dict(mesh=-1, translation=[0.0, 0.0, 0.0], rotation=[-r2, 0.0, 0.0, r2],
                  children=[1, 2, 3]),
             dict(mesh=0, translation=[0.0, 0.0, 0.0], rotation=[0.0, 0.0, 0.0, 1.0],
                  children=[])]
    for i, pos in enumerate((KEY_POS, FILL_POS)):
        nodes.append(dict(mesh=-1, translation=list(pos),
                          rotation=_look_quat(target - np.asarray(pos)), children=[],
                          extensions={"KHR_lights_punctual": {"light": i}}))
    return dict(prims=prims, materials=materials, textures=textures, nodes=nodes, roots=[0],
                extensions={"KHR_lights_punctual": {"lights": LIGHTS}},
                extensions_used=["KHR_lights_punctual", "KHR_materials_clearcoat",
                                 "KHR_materials_ior", "KHR_materials_sheen",
                                 "KHR_materials_transmission", "KHR_texture_transform"])
