"""Pure-Python glTF 2.0 / GLB loader -> host Scene (numpy).

Copy of gltf_renderer_tpu/scene/gltf.py, filling the port's scene types.
Capability mirror of the reference loader (Gltf.cpp:890-947 LoadFromGltf and
helpers): meshes with all vertex streams, 10:10:10:2 tangent-space
quantization applied at load (Gltf.cpp:23-104 — including the half-turn decode
quirk, see utils/math.decode_tangent_space), materials incl. KHR extensions
(Gltf.cpp:467-630), textures packed into one atlas, samplers, scene graph,
skins (Gltf.cpp:810-837), morph targets, animations (Gltf.cpp:707-808),
punctual lights (Gltf.cpp:856-882), cameras. No tinygltf — JSON/GLB parsed
directly; accessors (incl. sparse, strided, normalized) in numpy
(TinyGltfTools.h equivalents).
"""

from __future__ import annotations

import base64
import json
import logging
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.scene.textures import AtlasBuilder, decode_image_bytes

log = logging.getLogger(__name__)

SUPPORTED_EXTENSIONS = {
    # Parity with the reference's supported set (Gltf.cpp:921-933 checks
    # extensionsRequired against what it implements).
    "KHR_texture_transform",
    "KHR_materials_anisotropy",
    "KHR_materials_clearcoat",
    "KHR_materials_dispersion",
    "KHR_materials_emissive_strength",
    "KHR_materials_ior",
    "KHR_materials_iridescence",
    "KHR_materials_sheen",
    "KHR_materials_specular",
    "KHR_materials_transmission",
    "KHR_materials_volume",
    "KHR_materials_unlit",
    "KHR_lights_punctual",
}

_COMPONENT_DTYPE = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNT = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


# ---------------------------------------------------------------------------
# Container / buffers
# ---------------------------------------------------------------------------

def _read_glb(data: bytes) -> Tuple[dict, Optional[bytes]]:
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    offset = 12
    gltf_json, bin_chunk = None, None
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # JSON
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # BIN
            bin_chunk = chunk
    return gltf_json, bin_chunk


def _decode_uri(uri: str, base_dir: str) -> bytes:
    if uri.startswith("data:"):
        comma = uri.index(",")
        return base64.b64decode(uri[comma + 1 :])
    path = os.path.join(base_dir, uri.replace("%20", " "))
    with open(path, "rb") as f:
        return f.read()


class _Reader:
    """Accessor plumbing (TinyGltfTools.h:284-391 equivalent)."""

    def __init__(self, doc: dict, buffers: List[bytes]):
        self.doc = doc
        self.buffers = buffers

    def buffer_view(self, idx: int) -> Tuple[bytes, int, int]:
        bv = self.doc["bufferViews"][idx]
        data = self.buffers[bv.get("buffer", 0)]
        off = bv.get("byteOffset", 0)
        return data, off, bv.get("byteStride", 0)

    def accessor(self, idx: int) -> np.ndarray:
        """Returns (count, components) float32/int array, normalization applied
        (unorm/snorm 8/16 per TinyGltfTools.h:336-351)."""
        acc = self.doc["accessors"][idx]
        count = acc["count"]
        ncomp = _TYPE_COUNT[acc["type"]]
        dtype = _COMPONENT_DTYPE[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize

        if "bufferView" in acc:
            data, base_off, stride = self.buffer_view(acc["bufferView"])
            off = base_off + acc.get("byteOffset", 0)
            elem_size = itemsize * ncomp
            if stride and stride != elem_size:
                raw = np.frombuffer(
                    data, np.uint8, count=max(stride * (count - 1) + elem_size, 0), offset=off
                )
                raw = np.lib.stride_tricks.as_strided(
                    raw, shape=(count, elem_size), strides=(stride, 1)
                ).copy()
                out = raw.view(dtype).reshape(count, ncomp)
            else:
                out = np.frombuffer(data, dtype, count=count * ncomp, offset=off).reshape(
                    count, ncomp
                )
            out = out.copy()
        else:
            out = np.zeros((count, ncomp), dtype)

        if "sparse" in acc:
            sp = acc["sparse"]
            n = sp["count"]
            idx_acc = sp["indices"]
            ind_dtype = _COMPONENT_DTYPE[idx_acc["componentType"]]
            data, base_off, _ = self.buffer_view(idx_acc["bufferView"])
            indices = np.frombuffer(
                data, ind_dtype, count=n, offset=base_off + idx_acc.get("byteOffset", 0)
            ).astype(np.int64)
            val_acc = sp["values"]
            data, base_off, _ = self.buffer_view(val_acc["bufferView"])
            values = np.frombuffer(
                data, dtype, count=n * ncomp, offset=base_off + val_acc.get("byteOffset", 0)
            ).reshape(n, ncomp)
            out[indices] = values

        if acc.get("normalized", False) and dtype != np.float32:
            info = np.iinfo(dtype)
            if info.min < 0:  # snorm
                out = np.maximum(out.astype(np.float32) / info.max, -1.0)
            else:  # unorm
                out = out.astype(np.float32) / info.max
        return out


# ---------------------------------------------------------------------------
# Tangent-space quantization (numpy; parity with Gltf.cpp:23-104)
# ---------------------------------------------------------------------------

def _np_sign_not_zero(x):
    return np.where(x >= 0.0, 1.0, -1.0)


def _np_encode_octahedral(n):
    octa = n / np.abs(n).sum(-1, keepdims=True)
    xy = octa[..., :2]
    folded = _np_sign_not_zero(xy) * (1.0 - np.abs(octa[..., [1, 0]]))
    return np.where(octa[..., 2:3] >= 0.0, xy, folded)


def _np_decode_octahedral(e):
    z = 1.0 - np.abs(e[..., 0:1]) - np.abs(e[..., 1:2])
    xy = np.where(z >= 0.0, e, _np_sign_not_zero(e) * (1.0 - np.abs(e[..., [1, 0]])))
    v = np.concatenate([xy, z], -1)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _np_basis(n):
    s = np.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t = np.concatenate([1.0 + s * n[..., 0:1] ** 2 * a, s * b, -s * n[..., 0:1]], -1)
    bt = np.concatenate([b, s + n[..., 1:2] ** 2 * a, -n[..., 1:2]], -1)
    return t, bt


def quantize_tangent_space(normal: np.ndarray, tangent: Optional[np.ndarray]):
    """Encode+decode roundtrip of the 10:10:10:2 codec so pool values equal
    what the reference shaders see after quantization (Gltf.cpp:65-104 encode,
    Vertex.hlsli:5-20 decode — including the half-turn decode quirk)."""
    en = np.clip(0.5 * _np_encode_octahedral(normal) + 0.5, 0.0, 1.0)
    qn = np.floor(en * 1023.0 + 0.5)
    n2 = _np_decode_octahedral(2.0 * (qn / 1023.0) - 1.0)
    ct, cb = _np_basis(n2)
    if tangent is None:
        # EncodeNormal (Gltf.cpp:65-77): tangent bits = 0, winding = +1.
        qt = np.zeros(normal.shape[:-1])
        w = np.ones(normal.shape[:-1])
    else:
        angle = np.arctan2(
            (tangent[..., :3] * cb).sum(-1), (tangent[..., :3] * ct).sum(-1)
        )
        et = np.clip(angle / (2 * np.pi) + 0.5, 0.0, 1.0)
        qt = np.floor(et * 1023.0 + 0.5)
        w = np.where(tangent[..., 3] == 1.0, 1.0, -1.0)
    # Decode (Vertex.hlsli:5-20): angle = TAU * (qt / 1023) — no -0.5.
    dec_angle = 2 * np.pi * (qt / 1023.0)
    t_dec = np.cos(dec_angle)[..., None] * ct + np.sin(dec_angle)[..., None] * cb
    return (
        n2.astype(np.float32),
        np.concatenate([t_dec, w[..., None]], -1).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

_WRAP_MAP = {10497: T.WRAP_REPEAT, 33071: T.WRAP_CLAMP, 33648: T.WRAP_MIRROR}


class _TextureLoader:
    """Lazy per-(gltf texture, srgb) atlas uploads (Gltf.cpp:1048-1078)."""

    def __init__(self, doc, buffers, reader, base_dir):
        self.doc = doc
        self.buffers = buffers
        self.reader = reader
        self.base_dir = base_dir
        self.atlas = AtlasBuilder()
        self.cache: Dict[Tuple[int, bool], int] = {}
        self.meta: List[Tuple[int, int, int, int]] = []  # wrap_s, wrap_t, nearest, srgb
        self._image_cache: Dict[int, np.ndarray] = {}

    def _image(self, idx: int) -> np.ndarray:
        if idx in self._image_cache:
            return self._image_cache[idx]
        img_def = self.doc["images"][idx]
        if "bufferView" in img_def:
            data, off, _ = self.reader.buffer_view(img_def["bufferView"])
            length = self.doc["bufferViews"][img_def["bufferView"]]["byteLength"]
            raw = bytes(data[off : off + length])
        else:
            raw = _decode_uri(img_def["uri"], self.base_dir)
        img = decode_image_bytes(raw)
        self._image_cache[idx] = img
        return img

    def get(self, tex_id: int, srgb: bool) -> int:
        """glTF texture id -> atlas texture index (creating on first use)."""
        if tex_id is None or tex_id < 0:
            return -1
        key = (tex_id, srgb)
        if key in self.cache:
            return self.cache[key]
        tex_def = self.doc["textures"][tex_id]
        src = tex_def.get("source", -1)
        if src < 0:
            return -1
        img = self._image(src)
        slot = self.atlas.add(img)
        wrap_s = wrap_t = T.WRAP_REPEAT
        nearest = 0
        if "sampler" in tex_def:
            smp = self.doc.get("samplers", [])[tex_def["sampler"]]
            wrap_s = _WRAP_MAP.get(smp.get("wrapS", 10497), T.WRAP_REPEAT)
            wrap_t = _WRAP_MAP.get(smp.get("wrapT", 10497), T.WRAP_REPEAT)
            nearest = 1 if smp.get("magFilter", 9729) == 9728 else 0
        self.meta.append((wrap_s, wrap_t, nearest, 1 if srgb else 0))
        self.cache[key] = slot
        return slot

    def build_table(self) -> T.TextureTable:
        atlas, rects = self.atlas.build()
        n = len(self.meta)
        meta = np.asarray(self.meta, np.int32).reshape(n, 4) if n else np.zeros((0, 4), np.int32)
        table = T.TextureTable(
            atlas=atlas,
            x=rects[:, 0] if n else np.zeros(0, np.int32),
            y=rects[:, 1] if n else np.zeros(0, np.int32),
            width=rects[:, 2] if n else np.zeros(0, np.int32),
            height=rects[:, 3] if n else np.zeros(0, np.int32),
            wrap_s=meta[:, 0],
            wrap_t=meta[:, 1],
            nearest=meta[:, 2],
            srgb=meta[:, 3],
        )
        return table._replace(rows=T.pack_texture_rows(table))


def _tex_info(mat_ext: dict, name: str) -> Tuple[int, int, dict]:
    """Returns (texture id, texcoord set, transform dict) from a textureInfo."""
    info = mat_ext.get(name)
    if not isinstance(info, dict) or "index" not in info:
        return -1, 0, {}
    xform = info.get("extensions", {}).get("KHR_texture_transform", {})
    return info["index"], info.get("texCoord", 0), xform


def load_gltf(path: str) -> T.Scene:
    """Load a .gltf or .glb file into a host Scene."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] == b"glTF":
        doc, bin_chunk = _read_glb(raw)
    else:
        doc = json.loads(raw.decode("utf-8"))
        bin_chunk = None

    # Required-extension check (Gltf.cpp:921-933).
    for ext in doc.get("extensionsRequired", []):
        if ext not in SUPPORTED_EXTENSIONS:
            raise ValueError(f"unsupported required extension: {ext}")

    buffers = []
    for buf in doc.get("buffers", []):
        if "uri" in buf:
            buffers.append(_decode_uri(buf["uri"], base_dir))
        else:
            buffers.append(bin_chunk)
    reader = _Reader(doc, buffers)
    texloader = _TextureLoader(doc, buffers, reader, base_dir)

    materials = _load_materials(doc, texloader)
    iridescence = _load_iridescence(doc)
    pools, primitives, meshes = _load_meshes(doc, reader)
    nodes, scenes, default_scene, topo = _load_nodes(doc)
    skins = _load_skins(doc, reader)
    animations = _load_animations(doc, reader)
    cameras = _load_cameras(doc)
    light_params, light_node_map = _load_lights(doc, nodes)

    return T.Scene(
        pools=pools,
        primitives=primitives,
        materials=materials,
        textures=texloader.build_table(),
        light_params=light_params,
        light_nodes=light_node_map,
        nodes=nodes,
        scenes=scenes,
        default_scene=default_scene,
        meshes=meshes,
        skins=skins,
        animations=animations,
        cameras=cameras,
        iridescence=iridescence,
        topo_order=topo,
        name=os.path.basename(path),
    )


# ---------------------------------------------------------------------------
# Materials (Gltf.cpp:467-630 + Renderer.h GpuMaterial conversion)
# ---------------------------------------------------------------------------

def _load_materials(doc: dict, texloader: _TextureLoader) -> T.MaterialTable:
    n_mat = len(doc.get("materials", [])) + 1  # +1 default at index 0
    M = n_mat
    S = T.N_TEX_SLOTS
    f32 = lambda v, shape=(M,): np.full(shape, v, np.float32)
    tbl = dict(
        flags=np.zeros(M, np.int32),
        alpha_mode=np.zeros(M, np.int32),
        base_color_factor=np.tile(np.ones(4, np.float32), (M, 1)),
        metalness_factor=f32(1.0),
        roughness_factor=f32(1.0),
        occlusion_factor=f32(1.0),
        emissive_factor=np.zeros((M, 3), np.float32),
        alpha_cutoff=f32(0.0),
        ior=f32(1.5),
        normal_scale=f32(1.0),
        specular_factor=f32(1.0),
        specular_color_factor=np.ones((M, 3), np.float32),
        clearcoat_factor=f32(0.0),
        clearcoat_roughness_factor=f32(0.0),
        clearcoat_normal_scale=f32(1.0),
        anisotropy_strength=f32(0.0),
        anisotropy_rotation=f32(0.0),
        sheen_color_factor=np.zeros((M, 3), np.float32),
        sheen_roughness_factor=f32(0.0),
        transmission_factor=f32(0.0),
        thickness_factor=f32(0.0),
        attenuation_distance=f32(0.0),
        attenuation_color=np.ones((M, 3), np.float32),
        dispersion=f32(0.0),
        tex_index=np.full((M, S), -1, np.int32),
        tex_uvset=np.zeros((M, S), np.int32),
        tex_rotation=np.zeros((M, S), np.float32),
        tex_offset=np.zeros((M, S, 2), np.float32),
        tex_scale=np.ones((M, S, 2), np.float32),
    )

    def set_tex(row, slot, container, name, srgb):
        tex_id, uvset, xf = _tex_info(container, name)
        idx = texloader.get(tex_id, srgb)
        tbl["tex_index"][row, slot] = idx
        tbl["tex_uvset"][row, slot] = uvset
        if xf:
            tbl["tex_rotation"][row, slot] = xf.get("rotation", 0.0)
            tbl["tex_offset"][row, slot] = xf.get("offset", [0.0, 0.0])
            tbl["tex_scale"][row, slot] = xf.get("scale", [1.0, 1.0])
            if "texCoord" in xf:
                tbl["tex_uvset"][row, slot] = xf["texCoord"]
        return tex_id

    for i, mat in enumerate(doc.get("materials", [])):
        r = i + 1
        pbr = mat.get("pbrMetallicRoughness", {})
        tbl["base_color_factor"][r] = pbr.get("baseColorFactor", [1, 1, 1, 1])
        tbl["metalness_factor"][r] = pbr.get("metallicFactor", 1.0)
        tbl["roughness_factor"][r] = pbr.get("roughnessFactor", 1.0)
        set_tex(r, T.TEX_ALBEDO, pbr, "baseColorTexture", True)
        set_tex(r, T.TEX_METALLIC_ROUGHNESS, pbr, "metallicRoughnessTexture", False)

        set_tex(r, T.TEX_NORMAL, mat, "normalTexture", False)
        if "normalTexture" in mat:
            tbl["normal_scale"][r] = mat["normalTexture"].get("scale", 1.0)
        set_tex(r, T.TEX_OCCLUSION, mat, "occlusionTexture", False)
        if "occlusionTexture" in mat:
            tbl["occlusion_factor"][r] = mat["occlusionTexture"].get("strength", 1.0)
        set_tex(r, T.TEX_EMISSIVE, mat, "emissiveTexture", True)
        emissive = np.asarray(mat.get("emissiveFactor", [0, 0, 0]), np.float32)

        mode = mat.get("alphaMode", "OPAQUE")
        tbl["alpha_mode"][r] = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}[mode]
        # alpha_cutoff only set for MASK (Renderer.h:146).
        if mode == "MASK":
            tbl["alpha_cutoff"][r] = mat.get("alphaCutoff", 0.5)
        if mat.get("doubleSided", False):
            tbl["flags"][r] |= T.MATERIAL_FLAG_DOUBLE_SIDED

        ext = mat.get("extensions", {})
        emissive_strength = 1.0
        if "KHR_materials_emissive_strength" in ext:
            emissive_strength = ext["KHR_materials_emissive_strength"].get(
                "emissiveStrength", 1.0
            )
        tbl["emissive_factor"][r] = emissive_strength * emissive

        if "KHR_materials_ior" in ext:
            tbl["ior"][r] = ext["KHR_materials_ior"].get("ior", 1.5)
        if "KHR_materials_anisotropy" in ext:
            e = ext["KHR_materials_anisotropy"]
            tbl["anisotropy_strength"][r] = e.get("anisotropyStrength", 0.0)
            tbl["anisotropy_rotation"][r] = e.get("anisotropyRotation", 0.0)
            set_tex(r, T.TEX_ANISOTROPY, e, "anisotropyTexture", False)
        if "KHR_materials_clearcoat" in ext:
            e = ext["KHR_materials_clearcoat"]
            tbl["clearcoat_factor"][r] = e.get("clearcoatFactor", 0.0)
            tbl["clearcoat_roughness_factor"][r] = e.get("clearcoatRoughnessFactor", 0.0)
            set_tex(r, T.TEX_CLEARCOAT, e, "clearcoatTexture", False)
            set_tex(r, T.TEX_CLEARCOAT_ROUGHNESS, e, "clearcoatRoughnessTexture", False)
            set_tex(r, T.TEX_CLEARCOAT_NORMAL, e, "clearcoatNormalTexture", False)
            if "clearcoatNormalTexture" in e:
                tbl["clearcoat_normal_scale"][r] = e["clearcoatNormalTexture"].get("scale", 1.0)
        if "KHR_materials_sheen" in ext:
            e = ext["KHR_materials_sheen"]
            tbl["sheen_color_factor"][r] = e.get("sheenColorFactor", [0, 0, 0])
            tbl["sheen_roughness_factor"][r] = e.get("sheenRoughnessFactor", 0.0)
            set_tex(r, T.TEX_SHEEN_COLOR, e, "sheenColorTexture", True)
            set_tex(r, T.TEX_SHEEN_ROUGHNESS, e, "sheenRoughnessTexture", False)
        if "KHR_materials_specular" in ext:
            e = ext["KHR_materials_specular"]
            tbl["specular_factor"][r] = e.get("specularFactor", 1.0)
            tbl["specular_color_factor"][r] = e.get("specularColorFactor", [1, 1, 1])
            set_tex(r, T.TEX_SPECULAR, e, "specularTexture", False)
            set_tex(r, T.TEX_SPECULAR_COLOR, e, "specularColorTexture", True)
        if "KHR_materials_transmission" in ext:
            e = ext["KHR_materials_transmission"]
            tbl["transmission_factor"][r] = e.get("transmissionFactor", 0.0)
            set_tex(r, T.TEX_TRANSMISSION, e, "transmissionTexture", False)
        if "KHR_materials_volume" in ext:
            e = ext["KHR_materials_volume"]
            tbl["thickness_factor"][r] = e.get("thicknessFactor", 0.0)
            tbl["attenuation_distance"][r] = e.get("attenuationDistance", 0.0)
            tbl["attenuation_color"][r] = e.get("attenuationColor", [1, 1, 1])
            set_tex(r, T.TEX_THICKNESS, e, "thicknessTexture", False)
        if "KHR_materials_dispersion" in ext:
            # Stored, not shaded — reference parity (Gltf.cpp:543-547; note
            # the reference looks up the wrong key "KHR_dispersion", an
            # invisible bug we fix: the spec name is used here).
            tbl["dispersion"][r] = ext["KHR_materials_dispersion"].get(
                "dispersion", 0.0
            )
        if "KHR_materials_unlit" in ext:
            tbl["flags"][r] |= T.MATERIAL_FLAG_UNLIT

    table = T.MaterialTable(**tbl)
    return table._replace(rows=T.pack_material_rows(table))


# ---------------------------------------------------------------------------
# Meshes (Gltf.cpp:159-367)
# ---------------------------------------------------------------------------

def _load_meshes(doc: dict, reader: _Reader):
    pos_l, nrm_l, tan_l, uv0_l, uv1_l, col_l, jnt_l, wgt_l = [], [], [], [], [], [], [], []
    tri_v_l, tri_p_l = [], []
    mpos_l, mnrm_l, mtan_l = [], [], []
    prim_rows = []
    meshes: List[T.MeshDef] = []
    v_off = 0
    t_off = 0
    m_off = 0

    for mesh in doc.get("meshes", []):
        prim_ids = []
        for prim in mesh.get("primitives", []):
            mode = prim.get("mode", 4)
            if mode not in (4, 5):
                log.warning("unsupported primitive mode %d — skipped", mode)
                continue
            attrs = prim["attributes"]
            pos = reader.accessor(attrs["POSITION"]).astype(np.float32)
            nv = len(pos)

            has_ts = "NORMAL" in attrs
            if has_ts:
                nrm_in = reader.accessor(attrs["NORMAL"]).astype(np.float32)
                tan_in = (
                    reader.accessor(attrs["TANGENT"]).astype(np.float32)
                    if "TANGENT" in attrs
                    else None
                )
                nrm, tan = quantize_tangent_space(nrm_in, tan_in)
            else:
                nrm = np.zeros((nv, 3), np.float32)
                tan = np.concatenate(
                    [np.zeros((nv, 3), np.float32), np.ones((nv, 1), np.float32)], -1
                )

            has_uv0 = "TEXCOORD_0" in attrs
            uv0 = (
                reader.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                if has_uv0
                else np.zeros((nv, 2), np.float32)
            )
            has_uv1 = "TEXCOORD_1" in attrs
            uv1 = (
                reader.accessor(attrs["TEXCOORD_1"]).astype(np.float32)
                if has_uv1
                else np.zeros((nv, 2), np.float32)
            )
            has_col = "COLOR_0" in attrs
            if has_col:
                col = reader.accessor(attrs["COLOR_0"]).astype(np.float32)
                if col.shape[1] == 3:
                    col = np.concatenate([col, np.ones((nv, 1), np.float32)], -1)
                # Reference stores colors as RGBA16 unorm (Mesh.h formats).
                col = np.floor(np.clip(col, 0, 1) * 65535.0 + 0.5) / 65535.0
            else:
                col = np.ones((nv, 4), np.float32)
            has_jw = "JOINTS_0" in attrs and "WEIGHTS_0" in attrs
            if has_jw:
                jnt = reader.accessor(attrs["JOINTS_0"]).astype(np.int32)
                wgt = reader.accessor(attrs["WEIGHTS_0"]).astype(np.float32)
                # u16 quantization to match Skin.cs.hlsl:96-101 unpack.
                wgt = np.floor(np.clip(wgt, 0, 1) * 65535.0 + 0.5) / 65535.0
            else:
                jnt = np.zeros((nv, 4), np.int32)
                wgt = np.zeros((nv, 4), np.float32)

            if "indices" in prim:
                idx = reader.accessor(prim["indices"]).astype(np.int64).reshape(-1)
            else:
                idx = np.arange(nv, dtype=np.int64)
            if mode == 5:  # TRIANGLE_STRIP -> list
                tris = np.stack(
                    [idx[:-2], idx[1:-1], idx[2:]], -1
                )
                flip = np.arange(len(tris)) % 2 == 1
                tris[flip] = tris[flip][:, [0, 2, 1]]
            else:
                tris = idx.reshape(-1, 3)
            tris = tris + v_off

            # Morph targets (Gltf.cpp:323-367).
            targets = prim.get("targets", [])
            prim_m_off = m_off
            for tgt in targets:
                mp = (
                    reader.accessor(tgt["POSITION"]).astype(np.float32)
                    if "POSITION" in tgt
                    else np.zeros((nv, 3), np.float32)
                )
                mn = (
                    reader.accessor(tgt["NORMAL"]).astype(np.float32)
                    if "NORMAL" in tgt
                    else np.zeros((nv, 3), np.float32)
                )
                mt = (
                    reader.accessor(tgt["TANGENT"]).astype(np.float32)[:, :3]
                    if "TANGENT" in tgt
                    else np.zeros((nv, 3), np.float32)
                )
                mpos_l.append(mp)
                mnrm_l.append(mn)
                mtan_l.append(mt)
                m_off += nv

            pos_l.append(pos)
            nrm_l.append(nrm)
            tan_l.append(tan)
            uv0_l.append(uv0)
            uv1_l.append(uv1)
            col_l.append(col)
            jnt_l.append(jnt)
            wgt_l.append(wgt)
            tri_v_l.append(tris.astype(np.int32))
            prim_id = len(prim_rows)
            tri_p_l.append(np.full(len(tris), prim_id, np.int32))

            prim_rows.append(
                (
                    v_off,
                    nv,
                    t_off,
                    len(tris),
                    prim.get("material", -1) + 1,  # default material at 0
                    int(has_ts),
                    int(has_uv0),
                    int(has_uv1),
                    int(has_col),
                    int(has_jw),
                    prim_m_off,
                    len(targets),
                )
            )
            prim_ids.append(prim_id)
            v_off += nv
            t_off += len(tris)
        meshes.append(
            T.MeshDef(
                primitives=prim_ids,
                weights=np.asarray(mesh["weights"], np.float32) if "weights" in mesh else None,
            )
        )

    cat = lambda lst, shape, dtype=np.float32: (
        np.concatenate(lst, 0) if lst else np.zeros(shape, dtype)
    )
    pools = T.GeometryPools(
        positions=cat(pos_l, (0, 3)),
        normals=cat(nrm_l, (0, 3)),
        tangents=cat(tan_l, (0, 4)),
        uv0=cat(uv0_l, (0, 2)),
        uv1=cat(uv1_l, (0, 2)),
        color=cat(col_l, (0, 4)),
        joints=cat(jnt_l, (0, 4), np.int32),
        weights=cat(wgt_l, (0, 4)),
        tri_vertex=cat(tri_v_l, (0, 3), np.int32),
        tri_prim=cat(tri_p_l, (0,), np.int32),
        morph_pos=cat(mpos_l, (0, 3)),
        morph_normal=cat(mnrm_l, (0, 3)),
        morph_tangent=cat(mtan_l, (0, 3)),
    )
    rows = np.asarray(prim_rows, np.int32).reshape(-1, 12)
    primitives = T.PrimitiveTable(
        vertex_offset=rows[:, 0],
        vertex_count=rows[:, 1],
        tri_offset=rows[:, 2],
        tri_count=rows[:, 3],
        material=rows[:, 4],
        has_tangent_space=rows[:, 5],
        has_uv0=rows[:, 6],
        has_uv1=rows[:, 7],
        has_color=rows[:, 8],
        has_joints=rows[:, 9],
        morph_offset=rows[:, 10],
        morph_count=rows[:, 11],
    )
    return pools, primitives, meshes


# ---------------------------------------------------------------------------
# Nodes / scenes (Gltf.cpp:632-705)
# ---------------------------------------------------------------------------

def _decompose_matrix(m: np.ndarray):
    """Column-major glTF matrix -> (t, r_xyzw, s)."""
    m = np.asarray(m, np.float64).reshape(4, 4).T  # row-major now
    t = m[:3, 3].copy()
    rs = m[:3, :3]
    s = np.linalg.norm(rs, axis=0)
    # Guard negative determinant (mirrored transforms).
    if np.linalg.det(rs) < 0:
        s[0] = -s[0]
    r = rs / s[None, :]
    # Rotation matrix -> quaternion (xyzw).
    tr = np.trace(r)
    if tr > 0:
        w = np.sqrt(1.0 + tr) / 2
        x = (r[2, 1] - r[1, 2]) / (4 * w)
        y = (r[0, 2] - r[2, 0]) / (4 * w)
        z = (r[1, 0] - r[0, 1]) / (4 * w)
    else:
        i = np.argmax(np.diag(r))
        j, k = (i + 1) % 3, (i + 2) % 3
        q = np.zeros(4)
        q[i] = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 0.0)) / 2
        q[j] = (r[j, i] + r[i, j]) / (4 * q[i])
        q[k] = (r[k, i] + r[i, k]) / (4 * q[i])
        q[3] = (r[k, j] - r[j, k]) / (4 * q[i])
        x, y, z, w = q
    return (
        t.astype(np.float32),
        np.asarray([x, y, z, w], np.float32),
        s.astype(np.float32),
    )


def _load_nodes(doc: dict):
    nodes: List[T.Node] = []
    for nd in doc.get("nodes", []):
        node = T.Node(name=nd.get("name", ""))
        if "matrix" in nd:
            t, r, s = _decompose_matrix(nd["matrix"])
            node.translation, node.rotation, node.scale = t, r, s
        else:
            node.translation = np.asarray(nd.get("translation", [0, 0, 0]), np.float32)
            node.rotation = np.asarray(nd.get("rotation", [0, 0, 0, 1]), np.float32)
            node.scale = np.asarray(nd.get("scale", [1, 1, 1]), np.float32)
        node.children = list(nd.get("children", []))
        node.mesh = nd.get("mesh", -1)
        node.skin = nd.get("skin", -1)
        node.camera = nd.get("camera", -1)
        node.light = nd.get("extensions", {}).get("KHR_lights_punctual", {}).get("light", -1)
        if "weights" in nd:
            node.weights = np.asarray(nd["weights"], np.float32)
        nodes.append(node)
    for i, node in enumerate(nodes):
        for c in node.children:
            nodes[c].parent = i

    scenes = [list(s.get("nodes", [])) for s in doc.get("scenes", [{}])]
    default_scene = doc.get("scene", 0)

    # Topological order (parents first) for vectorized transform propagation.
    order: List[int] = []
    seen = [False] * len(nodes)

    def visit(i):
        stack = [i]
        while stack:
            j = stack.pop()
            if seen[j]:
                continue
            seen[j] = True
            order.append(j)
            stack.extend(reversed(nodes[j].children))

    for roots in scenes:
        for r in roots:
            visit(r)
    for i in range(len(nodes)):
        visit(i)
    return nodes, scenes, default_scene, np.asarray(order, np.int32)


def _load_skins(doc: dict, reader: _Reader) -> List[T.Skin]:
    skins = []
    for sk in doc.get("skins", []):
        joints = np.asarray(sk["joints"], np.int32)
        if "inverseBindMatrices" in sk:
            ibm = reader.accessor(sk["inverseBindMatrices"]).reshape(-1, 4, 4)
            # glTF matrices are column-major; transpose to row-major (M @ v).
            ibm = np.transpose(ibm, (0, 2, 1)).astype(np.float32)
        else:
            ibm = np.tile(np.eye(4, dtype=np.float32), (len(joints), 1, 1))
        skins.append(T.Skin(joints=joints, inverse_bind=ibm, skeleton=sk.get("skeleton", -1)))
    return skins


_PATH_MAP = {"translation": T.PATH_TRANSLATION, "rotation": T.PATH_ROTATION, "scale": T.PATH_SCALE, "weights": T.PATH_WEIGHTS}
_INTERP_MAP = {"STEP": T.INTERP_STEP, "LINEAR": T.INTERP_LINEAR, "CUBICSPLINE": T.INTERP_CUBICSPLINE}


def _load_animations(doc: dict, reader: _Reader) -> List[T.Animation]:
    anims = []
    for an in doc.get("animations", []):
        channels = []
        for ch in an.get("channels", []):
            target = ch.get("target", {})
            if "node" not in target:
                continue
            smp = an["samplers"][ch["sampler"]]
            times = reader.accessor(smp["input"]).reshape(-1).astype(np.float32)
            values = reader.accessor(smp["output"]).astype(np.float32)
            if target["path"] == "weights" and len(times):
                # Weights outputs are FLAT scalars: n_keys * n_targets
                # (x3 for CUBICSPLINE tangents) — reshape to one row per
                # (key[, tangent]) so multi-target morphs sample correctly
                # (Animation.cpp passes the element count; Gltf.cpp:747).
                factor = 3 if smp.get("interpolation") == "CUBICSPLINE" else 1
                rows = len(times) * factor
                per = max(values.size // rows, 1)
                values = values.reshape(rows, per)
            channels.append(
                T.AnimationChannel(
                    node=target["node"],
                    path=_PATH_MAP[target["path"]],
                    interpolation=_INTERP_MAP.get(smp.get("interpolation", "LINEAR"), T.INTERP_LINEAR),
                    times=times,
                    values=values,
                )
            )
        anims.append(T.Animation(name=an.get("name", f"animation_{len(anims)}"), channels=channels))
    return anims


def _load_iridescence(doc: dict) -> List[T.IridescenceParams]:
    """Parse KHR_materials_iridescence per material (index 0 = default).

    Parity with Gltf.cpp:571-584 — parsed and stored but unused by shading
    (the reference's Material.hlsli has no iridescence either)."""
    out = [T.IridescenceParams()]
    for mat in doc.get("materials", []):
        e = mat.get("extensions", {}).get("KHR_materials_iridescence", {})
        out.append(
            T.IridescenceParams(
                factor=e.get("iridescenceFactor", 0.0),
                ior=e.get("iridescenceIor", 1.3),
                thickness_minimum=e.get("iridescenceThicknessMinimum", 100.0),
                thickness_maximum=e.get("iridescenceThicknessMaximum", 400.0),
            )
        )
    return out


def _load_cameras(doc: dict) -> List[T.CameraDef]:
    cams = []
    for c in doc.get("cameras", []):
        if c.get("type") == "perspective":
            p = c.get("perspective", {})
            cams.append(
                T.CameraDef(
                    type="perspective",
                    yfov=p.get("yfov", 1.0),
                    aspect=p.get("aspectRatio", 0.0),
                    znear=p.get("znear", 0.1),
                    zfar=p.get("zfar", 0.0),
                )
            )
        else:
            o = c.get("orthographic", {})
            cams.append(
                T.CameraDef(
                    type="orthographic",
                    xmag=o.get("xmag", 1.0),
                    ymag=o.get("ymag", 1.0),
                    znear=o.get("znear", 0.1),
                    zfar=o.get("zfar", 100.0),
                )
            )
    return cams


def _load_lights(doc: dict, nodes: List[T.Node]):
    lights = doc.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
    n = len(lights)
    params = T.LightParams(
        type=np.zeros(n, np.int32),
        color=np.ones((n, 3), np.float32),
        intensity=np.ones(n, np.float32),
        cutoff=np.zeros(n, np.float32),
        inner_angle=np.zeros(n, np.float32),
        outer_angle=np.full(n, np.pi / 4.0, np.float32),
    )
    tmap = {"point": T.LIGHT_TYPE_POINT, "spot": T.LIGHT_TYPE_SPOT, "directional": T.LIGHT_TYPE_DIRECTIONAL}
    for i, li in enumerate(lights):
        params.type[i] = tmap.get(li.get("type", "point"), T.LIGHT_TYPE_POINT)
        params.color[i] = li.get("color", [1, 1, 1])
        params.intensity[i] = li.get("intensity", 1.0)
        params.cutoff[i] = li.get("range", 0.0)
        spot = li.get("spot", {})
        params.inner_angle[i] = spot.get("innerConeAngle", 0.0)
        params.outer_angle[i] = spot.get("outerConeAngle", np.pi / 4.0)

    # Per-scene light instances = nodes referencing a light.
    light_nodes = np.asarray(
        [i for i, nd in enumerate(nodes) if nd.light != -1], np.int32
    )
    return params, light_nodes
