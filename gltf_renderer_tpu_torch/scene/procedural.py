"""Procedural scenes built in memory (host numpy).

Each function returns the Scene that the JAX package's glTF loader produces
from the matching writer in gltf_renderer_tpu/scene/procedural.py, without
the glTF/PNG round trip, which is lossless, so the tables are identical:
the same vertex data, the same 10:10:10:2 tangent-space quantisation the
loader applies (scene/gltf.quantize_tangent_space), the same
material rows with the loader's default material at row 0, the same RGBA
textures shelf-packed into a 4096-wide atlas in the order the loader meets
them, and the same nodes.

- `textured_sphere_scene`: `write_textured_sphere_glb` (:174), the helmet
  bench scene (a UV sphere with one checkerboard base-colour texture).
- `courtyard_scene`: `write_courtyard_glb` (:895), the Sponza-class
  courtyard bench scene (floor, walls, pillars, metal spheres and
  alpha-MASKed double-sided banners; three textures; 273,856 triangles at
  density 1). Its nodes keep the writer's chain: a root rotated -90 degrees
  about X over the mesh and camera nodes, which the loader's Y-up -> Z-up
  basis at the roots turns back into the authored coordinates.
- `foliage_scene`: `write_foliage_gltf` (:715), an alpha-MASKed leaf quad
  over a floor quad, lit by one point light.
- `materials_scene`: `write_materials_gltf` (:615), the material zoo: four
  24x48 UV spheres (thin transmission with volume attenuation and ior,
  clearcoat, sheen, anisotropic metal) over an emissive floor quad.

The writers `write_box_gltf`, `write_textured_sphere_glb`,
`write_materials_gltf`, `write_courtyard_glb`, `write_skinned_gltf` and
`write_morph_gltf` are copies of the JAX package's (:115, :174, :615, :895,
:244, :573) and write the same bytes: the golden configurations and the
card read the files they write through the port's loader.
"""

from __future__ import annotations

import base64
import json

import numpy as np

from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.scene.gltf import quantize_tangent_space

ATLAS_WIDTH = 4096  # the loader's AtlasBuilder default


def box_mesh():
    """Unit cube centred at the origin, four vertices a face with the face's
    normal and uv. Returns (pos, normal, uv, idx)."""
    p, n, uv, idx = [], [], [], []
    faces = [
        (np.array([0, 0, 1]), np.array([1, 0, 0]), np.array([0, 1, 0])),
        (np.array([0, 0, -1]), np.array([-1, 0, 0]), np.array([0, 1, 0])),
        (np.array([1, 0, 0]), np.array([0, 0, -1]), np.array([0, 1, 0])),
        (np.array([-1, 0, 0]), np.array([0, 0, 1]), np.array([0, 1, 0])),
        (np.array([0, 1, 0]), np.array([1, 0, 0]), np.array([0, 0, -1])),
        (np.array([0, -1, 0]), np.array([1, 0, 0]), np.array([0, 0, 1])),
    ]
    for fn, fu, fv in faces:
        base = len(p)
        for su, sv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            p.append(0.5 * (fn + su * fu + sv * fv))
            n.append(fn)
            uv.append([(su + 1) / 2, (sv + 1) / 2])
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (np.asarray(p, np.float32), np.asarray(n, np.float32), np.asarray(uv, np.float32),
            np.asarray(idx, np.uint16))


def uv_sphere(n_lat=32, n_lon=64, radius=0.5):
    lat = np.linspace(0, np.pi, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts, norms, uvs = [], [], []
    for i, th in enumerate(lat):
        for j, ph in enumerate(lon):
            d = np.array([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)])
            verts.append(radius * d)
            norms.append(d)
            uvs.append([j / n_lon, i / (n_lat - 1)])
    idx = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            idx += [a, b, c, b, d, c]  # CCW seen from outside
    return (np.asarray(verts, np.float32), np.asarray(norms, np.float32),
            np.asarray(uvs, np.float32), np.asarray(idx, np.uint32))


def checker_image(tex_size: int) -> np.ndarray:
    """(tex_size, tex_size, 4) u8 checkerboard of the bench texture."""
    yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size), indexing="ij")
    checker = (((xx // 8) + (yy // 8)) % 2).astype(np.uint8)
    return np.stack([checker * 255, 64 + checker * 128, 255 - checker * 200,
                     np.full_like(checker, 255)], -1)


def _grid_idx(nu, nv):
    """Two triangles per cell of an (nu + 1) x (nv + 1) vertex grid (u major)."""
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).reshape(-1)
    b = ((i + 1) * (nv + 1) + j).reshape(-1)
    c = ((i + 1) * (nv + 1) + j + 1).reshape(-1)
    d = (i * (nv + 1) + j + 1).reshape(-1)
    return np.stack([a, b, c, a, c, d], 1).reshape(-1).astype(np.uint32)


def _quad_grid(origin, ax_u, ax_v, nu, nv):
    """Subdivided quad origin + u*ax_u + v*ax_v, u, v in [0, 1]. Returns
    (pos, normal, uv, idx)."""
    origin = np.asarray(origin, np.float32)
    ax_u = np.asarray(ax_u, np.float32)
    ax_v = np.asarray(ax_v, np.float32)
    uu, vv = np.meshgrid(np.linspace(0, 1, nu + 1, dtype=np.float32),
                         np.linspace(0, 1, nv + 1, dtype=np.float32), indexing="ij")
    p = origin[None, None] + uu[..., None] * ax_u + vv[..., None] * ax_v
    nrm = np.cross(ax_u, ax_v)
    nrm = nrm / max(np.linalg.norm(nrm), 1e-9)
    n = np.broadcast_to(nrm, p.shape).astype(np.float32)
    uv = np.stack([uu, vv], -1).astype(np.float32)
    return p.reshape(-1, 3), n.reshape(-1, 3), uv.reshape(-1, 2), _grid_idx(nu, nv)


def _cylinder(center, radius, height, n_seg, n_h):
    """Open cylinder around +Z. Returns (pos, normal, uv, idx)."""
    center = np.asarray(center, np.float32)
    th = np.linspace(0, 2 * np.pi, n_seg + 1, dtype=np.float32)
    z = np.linspace(0, height, n_h + 1, dtype=np.float32)
    tt, zz = np.meshgrid(th, z, indexing="ij")
    p = np.stack([center[0] + radius * np.cos(tt), center[1] + radius * np.sin(tt),
                  center[2] + zz], -1).astype(np.float32)
    n = np.stack([np.cos(tt), np.sin(tt), np.zeros_like(tt)], -1).astype(np.float32)
    uv = np.stack([tt / (2 * np.pi), zz / height], -1).astype(np.float32)
    return p.reshape(-1, 3), n.reshape(-1, 3), uv.reshape(-1, 2), _grid_idx(n_seg, n_h)


def _material_table(mats) -> T.MaterialTable:
    """The loader's default material (row 0) followed by one row per entry
    of `mats`, dicts with any of: base (RGBA factor), metallic, roughness,
    albedo (base-colour texture id), mask_cutoff (alpha MASK with this
    cutoff), double_sided, and any MaterialTable field by name (the KHR
    extensions' factors). Loader defaults elsewhere."""
    m, s = len(mats) + 1, T.N_TEX_SLOTS

    def f32(v, shape=(m,)):
        return np.full(shape, v, np.float32)

    tbl = dict(
        flags=np.zeros(m, np.int32), alpha_mode=np.zeros(m, np.int32),
        base_color_factor=np.tile(np.ones(4, np.float32), (m, 1)),
        metalness_factor=f32(1.0), roughness_factor=f32(1.0), occlusion_factor=f32(1.0),
        emissive_factor=np.zeros((m, 3), np.float32), alpha_cutoff=f32(0.0), ior=f32(1.5),
        normal_scale=f32(1.0), specular_factor=f32(1.0),
        specular_color_factor=np.ones((m, 3), np.float32), clearcoat_factor=f32(0.0),
        clearcoat_roughness_factor=f32(0.0), clearcoat_normal_scale=f32(1.0),
        anisotropy_strength=f32(0.0), anisotropy_rotation=f32(0.0),
        sheen_color_factor=np.zeros((m, 3), np.float32), sheen_roughness_factor=f32(0.0),
        transmission_factor=f32(0.0), thickness_factor=f32(0.0),
        attenuation_distance=f32(0.0), attenuation_color=np.ones((m, 3), np.float32),
        dispersion=f32(0.0), tex_index=np.full((m, s), -1, np.int32),
        tex_uvset=np.zeros((m, s), np.int32), tex_rotation=np.zeros((m, s), np.float32),
        tex_offset=np.zeros((m, s, 2), np.float32), tex_scale=np.ones((m, s, 2), np.float32),
    )
    for r, mat in enumerate(mats, start=1):
        tbl["base_color_factor"][r] = mat.get("base", [1, 1, 1, 1])
        tbl["metalness_factor"][r] = mat["metallic"]
        tbl["roughness_factor"][r] = mat["roughness"]
        tbl["tex_index"][r, T.TEX_ALBEDO] = mat.get("albedo", -1)
        if "mask_cutoff" in mat:
            tbl["alpha_mode"][r] = T.ALPHA_MODE_MASK
            tbl["alpha_cutoff"][r] = mat["mask_cutoff"]
        if mat.get("double_sided", False):
            tbl["flags"][r] |= T.MATERIAL_FLAG_DOUBLE_SIDED
        for key in mat.keys() & tbl.keys():
            tbl[key][r] = mat[key]
    table = T.MaterialTable(**tbl)
    return table._replace(rows=T.pack_material_rows(table))


def _texture_table(images, wrap_t=T.WRAP_REPEAT) -> T.TextureTable:
    """sRGB textures shelf-packed into one atlas as the loader's
    AtlasBuilder packs them (gltf_renderer_tpu/scene/textures.py), in the
    order given; wrap_s REPEAT, wrap_t `wrap_t`, linear filtering."""
    rects, x, y, shelf_h = [], 0, 0, 0
    for img in images:
        h, w = img.shape[:2]
        if x + w > ATLAS_WIDTH:
            y, shelf_h, x = y + shelf_h, 0, 0
        rects.append((x, y, w, h))
        x += w
        shelf_h = max(shelf_h, h)
    height = -(-max(y + shelf_h, 1) // 8) * 8
    atlas = np.zeros((height, ATLAS_WIDTH, 4), np.uint8)
    for (rx, ry, w, h), img in zip(rects, images):
        atlas[ry:ry + h, rx:rx + w] = img
    rects = np.asarray(rects, np.int32).reshape(-1, 4)
    n = len(images)

    def i32(v):
        return np.full(n, v, np.int32)

    table = T.TextureTable(
        atlas=atlas, x=rects[:, 0], y=rects[:, 1], width=rects[:, 2], height=rects[:, 3],
        wrap_s=i32(T.WRAP_REPEAT), wrap_t=i32(wrap_t), nearest=i32(0), srgb=i32(1),
    )
    return table._replace(rows=T.pack_texture_rows(table))


def _node(mesh=-1, translation=(0, 0, 0), rotation=(0, 0, 0, 1), **kw) -> T.Node:
    return T.Node(translation=np.asarray(translation, np.float32),
                  rotation=np.asarray(rotation, np.float32), scale=np.ones(3, np.float32),
                  mesh=mesh, **kw)


def _mesh_scene(prims, materials, textures, nodes, roots, lights=None,
                light_nodes=()) -> T.Scene:
    """Scene from per-primitive (pos, normal, uv, idx, material row), one
    mesh per entry of `prims` (a list of primitive lists), as the loader
    reads primitives with POSITION, NORMAL and TEXCOORD_0."""
    cols = {k: [] for k in ("p", "n", "t", "uv", "tri", "tp")}
    rows, meshes, v_off, t_off = [], [], 0, 0
    for mesh in prims:
        ids = []
        for pos, nrm, uv, idx, mat in mesh:
            nv = len(pos)
            n_q, t_q = quantize_tangent_space(np.asarray(nrm, np.float32), None)
            tris = np.asarray(idx).astype(np.int64).reshape(-1, 3) + v_off
            cols["p"].append(np.asarray(pos, np.float32))
            cols["n"].append(n_q)
            cols["t"].append(t_q)
            cols["uv"].append(np.asarray(uv, np.float32))
            cols["tri"].append(tris.astype(np.int32))
            cols["tp"].append(np.full(len(tris), len(rows), np.int32))
            ids.append(len(rows))
            rows.append((v_off, nv, t_off, len(tris), mat, 1, 1, 0, 0, 0, 0, 0))
            v_off += nv
            t_off += len(tris)
        meshes.append(T.MeshDef(primitives=ids))
    pools = T.GeometryPools(
        positions=np.concatenate(cols["p"]), normals=np.concatenate(cols["n"]),
        tangents=np.concatenate(cols["t"]), uv0=np.concatenate(cols["uv"]),
        uv1=np.zeros((v_off, 2), np.float32), color=np.ones((v_off, 4), np.float32),
        joints=np.zeros((v_off, 4), np.int32), weights=np.zeros((v_off, 4), np.float32),
        tri_vertex=np.concatenate(cols["tri"]), tri_prim=np.concatenate(cols["tp"]),
        morph_pos=np.zeros((0, 3), np.float32), morph_normal=np.zeros((0, 3), np.float32),
        morph_tangent=np.zeros((0, 3), np.float32),
    )
    rows = np.asarray(rows, np.int32)
    for i, nd in enumerate(nodes):
        for c in nd.children:
            nodes[c].parent = i
    order = []
    for r in roots:  # parents first, children in order (the loader's topo order)
        stack = [r]
        while stack:
            j = stack.pop()
            order.append(j)
            stack.extend(reversed(nodes[j].children))
    return T.Scene(
        pools=pools, primitives=T.PrimitiveTable(*[rows[:, k] for k in range(12)]),
        materials=materials, textures=textures,
        light_params=lights if lights is not None else T.LightParams(
            np.zeros(0, np.int32), np.zeros((0, 3), np.float32), *[np.zeros(0, np.float32)] * 4),
        light_nodes=np.asarray(light_nodes, np.int32), nodes=nodes, scenes=[list(roots)],
        default_scene=0, meshes=meshes, topo_order=np.asarray(order, np.int32),
    )


def textured_sphere_scene(tex_size=64, n_lat=16, n_lon=32, metallic=0.0,
                          roughness=0.8) -> T.Scene:
    """The Scene of `write_textured_sphere_glb(...)` + `load_gltf`."""
    p, n, uv, idx = uv_sphere(n_lat, n_lon)
    return _mesh_scene(
        [[(p, n, uv, idx, 1)]],
        _material_table([dict(metallic=metallic, roughness=roughness, albedo=0)]),
        _texture_table([checker_image(tex_size)], wrap_t=T.WRAP_CLAMP),
        [_node(mesh=0)], roots=[0])


def courtyard_images(tex_size: int):
    """The courtyard's three RGBA u8 textures (stone checker, marble
    stripes, banner with a diamond cutout alpha), drawn as the writer draws
    them from RandomState(11)."""
    rs = np.random.RandomState(11)
    yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size), indexing="ij")
    checker = (((xx // 16) + (yy // 16)) % 2).astype(np.uint8)
    noise = rs.randint(0, 40, (tex_size, tex_size)).astype(np.uint8)
    stone = np.stack([150 + 30 * checker + noise // 2,
                      140 + 25 * checker + noise // 2,
                      125 + 20 * checker + noise // 2,
                      np.full_like(checker, 255)], -1).astype(np.uint8)
    stripes = (128 + 90 * np.sin(yy * 0.25 + 3 * np.sin(xx * 0.07))).astype(np.uint8)
    marble = np.stack([stripes, stripes, np.minimum(stripes + 20, 255),
                       np.full_like(stripes, 255)], -1).astype(np.uint8)
    cx = np.abs((xx % 64) - 32) + np.abs((yy % 64) - 32)
    alpha = np.where(cx < 40, 255, 0).astype(np.uint8)
    banner = np.stack([200 + 0 * xx, 40 + ((xx // 8) % 2) * 120, 40 + 0 * xx, alpha],
                      -1).astype(np.uint8)
    return [stone, marble, banner]


def _courtyard_groups(density: int):
    """The courtyard's five primitives (floor, walls, pillars, metal spheres,
    banners) as (pos, normal, uv, idx), parts concatenated in the writer's
    order with their indices offset."""
    d = density
    groups = {k: [] for k in ("floor", "wall", "pillar", "metal", "banner")}
    groups["floor"].append(_quad_grid([-10, -10, 0], [20, 0, 0], [0, 20, 0], 128 * d, 128 * d))
    for o, au in (([-10, -10, 0], [20, 0, 0]), ([10, 10, 0], [-20, 0, 0]),
                  ([10, -10, 0], [0, 20, 0]), ([-10, 10, 0], [0, -20, 0])):
        groups["wall"].append(_quad_grid(o, au, [0, 0, 6], 128 * d, 64 * d))
    for y in (-6.0, 6.0):
        for k in range(8):
            groups["pillar"].append(_cylinder([-8.4 + 2.4 * k, y, 0], 0.35, 5.0, 64 * d, 56 * d))
    for k in range(6):
        p, n, uv, idx = uv_sphere(32 * d, 48 * d, radius=0.5)
        groups["metal"].append((p + np.asarray([-7.5 + 3.0 * k, 0.0, 0.8], np.float32),
                                n, uv, idx))
    for k in range(7):
        x = -7.2 + 2.4 * k
        for y in (-6.0, 6.0):
            groups["banner"].append(_quad_grid([x - 0.8, y, 4.6], [1.6, 0, 0], [0, 0, -2.2],
                                               32 * d, 48 * d))
    prims = []
    for parts in groups.values():
        base, idxs = 0, []
        for part in parts:
            idxs.append(part[3] + base)
            base += part[0].shape[0]
        prims.append(tuple(np.concatenate([part[i] for part in parts]) for i in range(3))
                     + (np.concatenate(idxs),))
    return prims


def courtyard_scene(density: int = 1, tex_size: int = 256) -> T.Scene:
    """The Scene of `write_courtyard_glb(density, tex_size)` + `load_gltf`."""
    prims = [prim + (mat,) for mat, prim in enumerate(_courtyard_groups(density), start=1)]
    materials = _material_table([
        dict(albedo=0, metallic=0.0, roughness=0.9),
        dict(albedo=0, base=[0.9, 0.85, 0.8, 1.0], metallic=0.0, roughness=0.85),
        dict(albedo=1, metallic=0.05, roughness=0.4),
        dict(base=[0.95, 0.93, 0.88, 1.0], metallic=1.0, roughness=0.15),
        dict(albedo=2, metallic=0.0, roughness=1.0, mask_cutoff=0.5, double_sided=True),
    ])
    r2 = float(np.sqrt(0.5))
    nodes = [_node(rotation=(-r2, 0.0, 0.0, r2), children=[1, 2], name="zup_root"),
             _node(mesh=0),
             _node(translation=(-9.0, 0.0, 1.7), rotation=(0.5, -0.5, -0.5, 0.5), camera=0)]
    return _mesh_scene([prims], materials, _texture_table(courtyard_images(tex_size)), nodes,
                       roots=[0])


def foliage_image(tex_size: int) -> np.ndarray:
    """The leaf texture: green with circular alpha holes, RGBA u8."""
    yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size), indexing="ij")
    cx = tex_size / 2
    r = np.sqrt((xx - cx) ** 2 + (yy - cx) ** 2)
    alpha = np.where((r % 16) < 8, 255, 0).astype(np.uint8)
    return np.stack([np.full_like(alpha, 40), np.full_like(alpha, 160),
                     np.full_like(alpha, 40), alpha], -1)


def foliage_scene(tex_size: int = 64) -> T.Scene:
    """The Scene of `write_foliage_gltf(tex_size)` + `load_gltf`."""
    quad_uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    leaf = (np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32),
            np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1)), quad_uv,
            np.asarray([0, 1, 2, 0, 2, 3]), 1)
    floor = (np.asarray([[-4, -2, -4], [4, -2, -4], [4, -2, 4], [-4, -2, 4]], np.float32),
             np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1)), quad_uv,
             np.asarray([0, 2, 1, 0, 3, 2]), 2)
    materials = _material_table([
        dict(albedo=0, metallic=0.0, roughness=0.8, mask_cutoff=0.5, double_sided=True),
        dict(base=[0.8, 0.8, 0.8, 1], metallic=0.0, roughness=0.9),
    ])
    lights = T.LightParams(
        type=np.asarray([T.LIGHT_TYPE_POINT], np.int32), color=np.ones((1, 3), np.float32),
        intensity=np.asarray([60.0], np.float32), cutoff=np.zeros(1, np.float32),
        inner_angle=np.zeros(1, np.float32), outer_angle=np.full(1, np.pi / 4.0, np.float32))
    nodes = [_node(mesh=0), _node(mesh=1), _node(translation=(0, 1.5, 2.5), light=0)]
    return _mesh_scene([[leaf], [floor]], materials, _texture_table([foliage_image(tex_size)]),
                       nodes, roots=[0, 1, 2], lights=lights, light_nodes=[2])


def materials_scene() -> T.Scene:
    """The Scene of `write_materials_gltf` + `load_gltf`: the material zoo.
    The spheres share one accessor set in the file, which the loader reads
    once a primitive."""
    p, n, uv, idx = uv_sphere(24, 48)
    floor = (np.asarray([[-4, -0.5, -4], [4, -0.5, -4], [4, -0.5, 4], [-4, -0.5, 4]],
                        np.float32),
             np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1)),
             np.asarray([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32),
             np.asarray([0, 2, 1, 0, 3, 2]), 5)
    materials = _material_table([
        dict(base=[1, 1, 1, 1], metallic=0.0, roughness=0.05, transmission_factor=1.0,
             thickness_factor=0.5, attenuation_distance=0.5,
             attenuation_color=[0.9, 0.4, 0.3], ior=1.5),
        dict(base=[0.6, 0.05, 0.05, 1], metallic=0.4, roughness=0.5, clearcoat_factor=1.0,
             clearcoat_roughness_factor=0.05),
        dict(base=[0.1, 0.1, 0.4, 1], metallic=0.0, roughness=0.9,
             sheen_color_factor=[0.6, 0.5, 0.4], sheen_roughness_factor=0.5),
        dict(base=[0.9, 0.85, 0.7, 1], metallic=1.0, roughness=0.3, anisotropy_strength=0.8,
             anisotropy_rotation=0.5),
        # KHR_materials_emissive_strength 0.4 times emissiveFactor (1, 1, 1).
        dict(base=[0.7, 0.7, 0.7, 1], metallic=0.0, roughness=0.9,
             emissive_factor=0.4 * np.ones(3, np.float32)),
    ])
    nodes = [_node(mesh=k, translation=(x, 0, 0))
             for k, x in enumerate((-1.8, -0.6, 0.6, 1.8))] + [_node(mesh=4)]
    return _mesh_scene([[(p, n, uv, idx, k)] for k in range(1, 5)] + [[floor]], materials,
                       _texture_table([]), nodes, roots=[0, 1, 2, 3, 4])


# ---------------------------------------------------------------------------
# Writers: copies of gltf_renderer_tpu/scene/procedural.py's, for the scenes
# the loader reads back on the card.
# ---------------------------------------------------------------------------

def _buf_uri(data: bytes) -> str:
    return "data:application/octet-stream;base64," + base64.b64encode(data).decode()


def _acc(doc, bin_parts, arr, target=None, acc_type=None, normalized=False):
    """Append arr to the binary blob and register a bufferView + accessor."""
    arr = np.ascontiguousarray(arr)
    comp_map = {np.dtype(np.float32): 5126, np.dtype(np.uint32): 5125,
                np.dtype(np.uint16): 5123, np.dtype(np.uint8): 5121,
                np.dtype(np.int16): 5122, np.dtype(np.int8): 5120}
    offset = sum(len(p) for p in bin_parts)
    pad = (-offset) % 4
    if pad:
        bin_parts.append(b"\x00" * pad)
        offset += pad
    data = arr.tobytes()
    bin_parts.append(data)
    doc.setdefault("bufferViews", []).append(
        {"buffer": 0, "byteOffset": offset, "byteLength": len(data),
         **({"target": target} if target else {})})
    if acc_type is None:
        acc_type = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}[
            1 if arr.ndim == 1 else arr.shape[-1] if arr.ndim == 2 else 16]
    count = len(arr)
    acc = {"bufferView": len(doc["bufferViews"]) - 1, "componentType": comp_map[arr.dtype],
           "count": count, "type": acc_type}
    if normalized:
        acc["normalized"] = True
    if acc_type == "VEC3" and arr.dtype == np.float32:
        acc["min"] = arr.reshape(count, -1).min(0).tolist()
        acc["max"] = arr.reshape(count, -1).max(0).tolist()
    doc.setdefault("accessors", []).append(acc)
    return len(doc["accessors"]) - 1


def _write_json(path, doc, bin_parts):
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_skinned_gltf(path, strips: int = 1):
    """Two-bone skinned quad strip with a rotation animation; `strips`
    copies, one skin and one mesh each, 0.6 apart along x."""
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    seg = 4
    pos, nrm, joints, weights, idx = [], [], [], [], []
    for i in range(seg + 1):
        y = i / seg * 2.0
        w1 = min(y / 2.0, 1.0)
        for x in (-0.1, 0.1):
            pos.append([x, y, 0.0])
            nrm.append([0.0, 0.0, 1.0])
            joints.append([0, 1, 0, 0])
            weights.append([1.0 - w1, w1, 0.0, 0.0])
    for i in range(seg):
        a = i * 2
        idx += [a, a + 1, a + 2, a + 1, a + 3, a + 2]
    ip = _acc(doc, bin_parts, np.asarray(pos, np.float32), target=34962)
    inn = _acc(doc, bin_parts, np.asarray(nrm, np.float32), target=34962)
    ij = _acc(doc, bin_parts, np.asarray(joints, np.uint16), target=34962)
    iw = _acc(doc, bin_parts, np.asarray(weights, np.float32), target=34962)
    ii = _acc(doc, bin_parts, np.asarray(idx, np.uint16), target=34963)
    ibm = np.stack([np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)])
    ibm[1][3][1] = -1.0  # column-major: the translation is the 4th column
    i_ibm = _acc(doc, bin_parts, ibm.reshape(2, 16), acc_type="MAT4")
    times = np.asarray([0.0, 1.0, 2.0], np.float32)
    angle = np.pi / 4
    rots = np.asarray([[0, 0, 0, 1], [0, 0, np.sin(angle / 2), np.cos(angle / 2)],
                       [0, 0, 0, 1]], np.float32)
    it = _acc(doc, bin_parts, times)
    ir = _acc(doc, bin_parts, rots)
    mesh_def = {"primitives": [{"attributes": {"POSITION": ip, "NORMAL": inn, "JOINTS_0": ij,
                                               "WEIGHTS_0": iw}, "indices": ii}]}
    doc["meshes"] = [dict(mesh_def) for _ in range(strips)]
    doc["skins"], doc["nodes"] = [], []
    channels, scene_nodes = [], []
    for s in range(strips):
        base = len(doc["nodes"])
        xoff = 0.6 * s
        doc["skins"].append({"joints": [base + 1, base + 2], "inverseBindMatrices": i_ibm})
        doc["nodes"] += [
            {"mesh": s, "skin": s, "translation": [xoff, 0.0, 0.0], "name": f"strip{s}"},
            {"children": [base + 2], "translation": [xoff, 0.0, 0.0], "name": f"root_joint{s}"},
            {"translation": [0, 1, 0], "name": f"tip_joint{s}"},
        ]
        channels.append({"sampler": 0, "target": {"node": base + 2, "path": "rotation"}})
        scene_nodes += [base, base + 1]
    doc["animations"] = [{"samplers": [{"input": it, "output": ir, "interpolation": "LINEAR"}],
                          "channels": channels}]
    doc["scenes"] = [{"nodes": scene_nodes}]
    return _write_json(path, doc, bin_parts)


def write_morph_gltf(path):
    """A box with one morph target (a bulge) and a weight animation."""
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    p, n, uv, idx = box_mesh()
    ip = _acc(doc, bin_parts, p, target=34962)
    inn = _acc(doc, bin_parts, n, target=34962)
    ii = _acc(doc, bin_parts, idx, target=34963)
    delta = np.zeros_like(p)
    delta[:, 1] = 0.5 * p[:, 0] ** 2
    imp = _acc(doc, bin_parts, delta, target=34962)
    it = _acc(doc, bin_parts, np.asarray([0.0, 1.0, 2.0], np.float32))
    iw = _acc(doc, bin_parts, np.asarray([0.0, 1.0, 0.0], np.float32))
    doc["meshes"] = [{"primitives": [{"attributes": {"POSITION": ip, "NORMAL": inn},
                                      "indices": ii, "targets": [{"POSITION": imp}]}],
                      "weights": [0.0]}]
    doc["nodes"] = [{"mesh": 0}]
    doc["animations"] = [{"samplers": [{"input": it, "output": iw, "interpolation": "LINEAR"}],
                          "channels": [{"sampler": 0, "target": {"node": 0, "path": "weights"}}]}]
    doc["scenes"] = [{"nodes": [0]}]
    return _write_json(path, doc, bin_parts)


def _png_bytes(img) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def _append_image(doc, bin_parts, png: bytes) -> int:
    """Append a PNG to the binary chunk (4-byte aligned) with its bufferView
    and image. Returns the image index."""
    offset = sum(len(b) for b in bin_parts)
    pad = (-offset) % 4
    if pad:
        bin_parts.append(b"\x00" * pad)
        offset += pad
    bin_parts.append(png)
    doc["bufferViews"].append({"buffer": 0, "byteOffset": offset, "byteLength": len(png)})
    doc.setdefault("images", []).append({"bufferView": len(doc["bufferViews"]) - 1,
                                         "mimeType": "image/png"})
    return len(doc["images"]) - 1


def _write_glb(path, doc, bin_parts):
    """The document and its binary chunk as a GLB file."""
    import struct

    blob = b"".join(bin_parts)
    blob += b"\x00" * ((-len(blob)) % 4)
    doc["buffers"] = [{"byteLength": len(blob)}]
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    glb = struct.pack("<III", 0x46546C67, 2, total)
    glb += struct.pack("<II", len(js), 0x4E4F534A) + js
    glb += struct.pack("<II", len(blob), 0x004E4942) + blob
    with open(path, "wb") as f:
        f.write(glb)
    return path


def write_box_gltf(path, base_color=(0.8, 0.2, 0.2, 1.0), metallic=0.0, roughness=0.6,
                   with_light=True, double_box=False):
    """The unit box (`box_mesh`) with a KHR punctual point light
    (intensity 40) at (2, 2, 2); with double_box a second instance 1.5
    along +X."""
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    p, n, uv, idx = box_mesh()
    attrs = {"POSITION": _acc(doc, bin_parts, p, target=34962),
             "NORMAL": _acc(doc, bin_parts, n, target=34962),
             "TEXCOORD_0": _acc(doc, bin_parts, uv, target=34962)}
    ii = _acc(doc, bin_parts, idx, target=34963)
    doc["meshes"] = [{"primitives": [{"attributes": attrs, "indices": ii, "material": 0}]}]
    doc["materials"] = [{"pbrMetallicRoughness": {"baseColorFactor": list(base_color),
                                                  "metallicFactor": metallic,
                                                  "roughnessFactor": roughness}}]
    nodes = [{"mesh": 0, "name": "box"}]
    scene_nodes = [0]
    if double_box:
        nodes.append({"mesh": 0, "translation": [1.5, 0.0, 0.0], "name": "box2"})
        scene_nodes.append(1)
    if with_light:
        doc["extensionsUsed"] = ["KHR_lights_punctual"]
        doc["extensions"] = {"KHR_lights_punctual": {
            "lights": [{"type": "point", "intensity": 40.0, "color": [1, 1, 1]}]}}
        nodes.append({"translation": [2.0, 2.0, 2.0],
                      "extensions": {"KHR_lights_punctual": {"light": 0}}, "name": "light"})
        scene_nodes.append(len(nodes) - 1)
    doc["nodes"] = nodes
    doc["scenes"] = [{"nodes": scene_nodes}]
    return _write_json(path, doc, bin_parts)


def write_textured_sphere_glb(path, tex_size=64, n_lat=16, n_lon=32, metallic=0.0,
                              roughness=0.8):
    """The textured sphere (`textured_sphere_scene`) as a GLB: one
    checkerboard PNG in the binary chunk, wrap REPEAT x CLAMP."""
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    p, n, uv, idx = uv_sphere(n_lat, n_lon)
    attrs = {"POSITION": _acc(doc, bin_parts, p, target=34962),
             "NORMAL": _acc(doc, bin_parts, n, target=34962),
             "TEXCOORD_0": _acc(doc, bin_parts, uv, target=34962)}
    ii = _acc(doc, bin_parts, idx, target=34963)
    _append_image(doc, bin_parts, _png_bytes(checker_image(tex_size)))
    doc["samplers"] = [{"wrapS": 10497, "wrapT": 33071}]
    doc["textures"] = [{"source": 0, "sampler": 0}]
    doc["materials"] = [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                  "metallicFactor": metallic,
                                                  "roughnessFactor": roughness}}]
    doc["meshes"] = [{"primitives": [{"attributes": attrs, "indices": ii, "material": 0}]}]
    doc["nodes"] = [{"mesh": 0}]
    doc["scenes"] = [{"nodes": [0]}]
    return _write_glb(path, doc, bin_parts)


def write_materials_gltf(path):
    """The material zoo (`materials_scene`): a transmissive sphere with
    volume attenuation and ior, a clearcoat sphere, a sheen sphere and an
    anisotropic metal sphere over an emissive floor quad."""
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    doc["extensionsUsed"] = [
        "KHR_materials_transmission", "KHR_materials_volume", "KHR_materials_clearcoat",
        "KHR_materials_sheen", "KHR_materials_anisotropy", "KHR_materials_ior",
        "KHR_materials_emissive_strength", "KHR_materials_specular",
    ]
    bin_parts = []

    def prim(p, n, uv, idx, **kw):
        return dict({"attributes": {"POSITION": _acc(doc, bin_parts, p, target=34962),
                                    "NORMAL": _acc(doc, bin_parts, n, target=34962),
                                    "TEXCOORD_0": _acc(doc, bin_parts, uv, target=34962)},
                     "indices": _acc(doc, bin_parts, idx, target=34963)}, **kw)

    sphere = prim(*uv_sphere(24, 48))
    # Floor quad (y = -0.5 in glTF space).
    floor = prim(np.asarray([[-4, -0.5, -4], [4, -0.5, -4], [4, -0.5, 4], [-4, -0.5, 4]],
                            np.float32),
                 np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1)),
                 np.asarray([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32),
                 np.asarray([0, 2, 1, 0, 3, 2], np.uint16), material=4)

    def mr(color, metallic, roughness):
        return {"baseColorFactor": color, "metallicFactor": metallic,
                "roughnessFactor": roughness}

    doc["materials"] = [
        {"pbrMetallicRoughness": mr([1, 1, 1, 1], 0.0, 0.05),
         "extensions": {
             "KHR_materials_transmission": {"transmissionFactor": 1.0},
             "KHR_materials_volume": {"thicknessFactor": 0.5, "attenuationDistance": 0.5,
                                      "attenuationColor": [0.9, 0.4, 0.3]},
             "KHR_materials_ior": {"ior": 1.5}}},
        {"pbrMetallicRoughness": mr([0.6, 0.05, 0.05, 1], 0.4, 0.5),
         "extensions": {"KHR_materials_clearcoat": {"clearcoatFactor": 1.0,
                                                    "clearcoatRoughnessFactor": 0.05}}},
        {"pbrMetallicRoughness": mr([0.1, 0.1, 0.4, 1], 0.0, 0.9),
         "extensions": {"KHR_materials_sheen": {"sheenColorFactor": [0.6, 0.5, 0.4],
                                                "sheenRoughnessFactor": 0.5}}},
        {"pbrMetallicRoughness": mr([0.9, 0.85, 0.7, 1], 1.0, 0.3),
         "extensions": {"KHR_materials_anisotropy": {"anisotropyStrength": 0.8,
                                                     "anisotropyRotation": 0.5}}},
        {"pbrMetallicRoughness": mr([0.7, 0.7, 0.7, 1], 0.0, 0.9),
         "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 0.4}},
         "emissiveFactor": [1.0, 1.0, 1.0]},
    ]
    doc["meshes"] = [{"primitives": [dict(sphere, material=m)]} for m in range(4)]
    doc["meshes"].append({"primitives": [floor]})
    doc["nodes"] = [{"mesh": m, "translation": [x, 0, 0]}
                    for m, x in enumerate((-1.8, -0.6, 0.6, 1.8))] + [{"mesh": 4}]
    doc["scenes"] = [{"nodes": [0, 1, 2, 3, 4]}]
    return _write_json(path, doc, bin_parts)


def write_courtyard_glb(path, density=1, tex_size=256):
    """The courtyard (`courtyard_scene`) as a GLB: five primitives, three
    PNG textures in the binary chunk, the colonnade camera, and the root
    rotation that keeps the authored Z-up coordinates as world ones."""
    doc = {"asset": {"version": "2.0"}, "scene": 0, "bufferViews": [], "accessors": []}
    bin_parts = []
    doc["materials"] = [
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}, "metallicFactor": 0.0,
                                  "roughnessFactor": 0.9}},
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                  "baseColorFactor": [0.9, 0.85, 0.8, 1.0],
                                  "metallicFactor": 0.0, "roughnessFactor": 0.85}},
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 1}, "metallicFactor": 0.05,
                                  "roughnessFactor": 0.4}},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.95, 0.93, 0.88, 1.0],
                                  "metallicFactor": 1.0, "roughnessFactor": 0.15}},
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 2}, "metallicFactor": 0.0,
                                  "roughnessFactor": 1.0},
         "alphaMode": "MASK", "alphaCutoff": 0.5, "doubleSided": True},
    ]
    prims = []
    for mi, (p, n, uv, idx) in enumerate(_courtyard_groups(density)):
        prims.append({"attributes": {"POSITION": _acc(doc, bin_parts, p, target=34962),
                                     "NORMAL": _acc(doc, bin_parts, n, target=34962),
                                     "TEXCOORD_0": _acc(doc, bin_parts, uv, target=34962)},
                      "indices": _acc(doc, bin_parts, idx, target=34963), "material": mi})
    doc["textures"] = [{"source": _append_image(doc, bin_parts, _png_bytes(img)), "sampler": 0}
                       for img in courtyard_images(tex_size)]
    doc["samplers"] = [{"wrapS": 10497, "wrapT": 10497}]
    doc["meshes"] = [{"primitives": prims}]
    doc["cameras"] = [{"type": "perspective", "perspective": {"yfov": 1.0472, "znear": 0.05}}]
    r2f = float(np.sqrt(0.5))
    doc["nodes"] = [
        {"rotation": [-r2f, 0.0, 0.0, r2f], "children": [1, 2], "name": "zup_root"},
        {"mesh": 0},
        {"camera": 0, "translation": [-9.0, 0.0, 1.7], "rotation": [0.5, -0.5, -0.5, 0.5]},
    ]
    doc["scenes"] = [{"nodes": [0]}]
    return _write_glb(path, doc, bin_parts)
