"""Procedural bench scene built in memory (host numpy).

`textured_sphere_scene` returns the Scene that the JAX package's glTF loader
produces from `write_textured_sphere_glb` (gltf_renderer_tpu/scene/
procedural.py:174): the same UV sphere, the same 10:10:10:2 tangent-space
quantization the loader applies (gltf_renderer_tpu/scene/gltf.py:196-221),
the same checkerboard base-colour texture in a one-rect atlas and the same
metallic-roughness material. Building it directly skips the GLB/PNG round
trip, which is lossless, so the tables are identical.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gltf_renderer_tpu_torch.scene import types as T

ATLAS_WIDTH = 4096  # the loader's AtlasBuilder default


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


def _sign_not_zero(x):
    return np.where(x >= 0.0, 1.0, -1.0)


def _encode_octahedral(n):
    octa = n / np.abs(n).sum(-1, keepdims=True)
    xy = octa[..., :2]
    folded = _sign_not_zero(xy) * (1.0 - np.abs(octa[..., [1, 0]]))
    return np.where(octa[..., 2:3] >= 0.0, xy, folded)


def _decode_octahedral(e):
    z = 1.0 - np.abs(e[..., 0:1]) - np.abs(e[..., 1:2])
    xy = np.where(z >= 0.0, e, _sign_not_zero(e) * (1.0 - np.abs(e[..., [1, 0]])))
    v = np.concatenate([xy, z], -1)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _basis(n):
    s = np.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t = np.concatenate([1.0 + s * n[..., 0:1] ** 2 * a, s * b, -s * n[..., 0:1]], -1)
    bt = np.concatenate([b, s + n[..., 1:2] ** 2 * a, -n[..., 1:2]], -1)
    return t, bt


def quantize_tangent_space(normal: np.ndarray, tangent: Optional[np.ndarray]):
    """Encode+decode round trip of the 10:10:10:2 tangent-space codec
    (Gltf.cpp:65-104 encode, Vertex.hlsli:5-20 decode, half-turn quirk)."""
    en = np.clip(0.5 * _encode_octahedral(normal) + 0.5, 0.0, 1.0)
    qn = np.floor(en * 1023.0 + 0.5)
    n2 = _decode_octahedral(2.0 * (qn / 1023.0) - 1.0)
    ct, cb = _basis(n2)
    if tangent is None:
        qt = np.zeros(normal.shape[:-1])
        w = np.ones(normal.shape[:-1])
    else:
        angle = np.arctan2((tangent[..., :3] * cb).sum(-1), (tangent[..., :3] * ct).sum(-1))
        et = np.clip(angle / (2 * np.pi) + 0.5, 0.0, 1.0)
        qt = np.floor(et * 1023.0 + 0.5)
        w = np.where(tangent[..., 3] == 1.0, 1.0, -1.0)
    dec_angle = 2 * np.pi * (qt / 1023.0)
    t_dec = np.cos(dec_angle)[..., None] * ct + np.sin(dec_angle)[..., None] * cb
    return n2.astype(np.float32), np.concatenate([t_dec, w[..., None]], -1).astype(np.float32)


def checker_image(tex_size: int) -> np.ndarray:
    """(tex_size, tex_size, 4) u8 checkerboard of the bench texture."""
    yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size), indexing="ij")
    checker = (((xx // 8) + (yy // 8)) % 2).astype(np.uint8)
    return np.stack([checker * 255, 64 + checker * 128, 255 - checker * 200,
                     np.full_like(checker, 255)], -1)


def _material_table(metallic: float, roughness: float) -> T.MaterialTable:
    """Default material (row 0) + the sphere's metallic-roughness material
    with the base-colour texture 0 (row 1), loader defaults elsewhere."""
    m, s = 2, T.N_TEX_SLOTS

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
    tbl["base_color_factor"][1] = [1, 1, 1, 1]
    tbl["metalness_factor"][1] = metallic
    tbl["roughness_factor"][1] = roughness
    tbl["tex_index"][1, T.TEX_ALBEDO] = 0
    table = T.MaterialTable(**tbl)
    return table._replace(rows=T.pack_material_rows(table))


def _texture_table(img: np.ndarray) -> T.TextureTable:
    """One-texture atlas as the loader's shelf packer lays it out."""
    h, w = img.shape[:2]
    height = -(-max(h, 1) // 8) * 8
    atlas = np.zeros((height, ATLAS_WIDTH, 4), np.uint8)
    atlas[:h, :w] = img
    i32 = lambda v: np.asarray([v], np.int32)
    table = T.TextureTable(
        atlas=atlas, x=i32(0), y=i32(0), width=i32(w), height=i32(h),
        wrap_s=i32(T.WRAP_REPEAT), wrap_t=i32(T.WRAP_CLAMP), nearest=i32(0), srgb=i32(1),
    )
    return table._replace(rows=T.pack_texture_rows(table))


def textured_sphere_scene(tex_size=64, n_lat=16, n_lon=32, metallic=0.0,
                          roughness=0.8) -> T.Scene:
    """The Scene of `write_textured_sphere_glb(...)` + `load_gltf`."""
    p, n, uv, idx = uv_sphere(n_lat, n_lon)
    nv = len(p)
    nrm, tan = quantize_tangent_space(n.astype(np.float32), None)
    tris = idx.astype(np.int64).reshape(-1, 3).astype(np.int32)
    nt = len(tris)
    pools = T.GeometryPools(
        positions=p, normals=nrm, tangents=tan, uv0=uv, uv1=np.zeros((nv, 2), np.float32),
        color=np.ones((nv, 4), np.float32), joints=np.zeros((nv, 4), np.int32),
        weights=np.zeros((nv, 4), np.float32), tri_vertex=tris,
        tri_prim=np.zeros(nt, np.int32), morph_pos=np.zeros((0, 3), np.float32),
        morph_normal=np.zeros((0, 3), np.float32), morph_tangent=np.zeros((0, 3), np.float32),
    )
    row = np.asarray([[0, nv, 0, nt, 1, 1, 1, 0, 0, 0, 0, 0]], np.int32)
    prims = T.PrimitiveTable(*[row[:, k] for k in range(12)])
    node = T.Node(translation=np.zeros(3, np.float32),
                  rotation=np.asarray([0, 0, 0, 1], np.float32),
                  scale=np.ones(3, np.float32), mesh=0)
    z = np.zeros(0, np.float32)
    lights = T.LightParams(np.zeros(0, np.int32), np.zeros((0, 3), np.float32), z, z, z, z)
    return T.Scene(
        pools=pools, primitives=prims, materials=_material_table(metallic, roughness),
        textures=_texture_table(checker_image(tex_size)), light_params=lights,
        light_nodes=np.zeros(0, np.int32), nodes=[node], scenes=[[0]], default_scene=0,
        meshes=[T.MeshDef(primitives=[0])], topo_order=np.asarray([0], np.int32),
    )
