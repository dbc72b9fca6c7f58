"""Write a scene dict (perfbench.scenes._geometry) as a binary glTF 2.0 file.

One mesh holding every primitive (POSITION, NORMAL, TEXCOORD_0, u32
indices), pbrMetallicRoughness materials with the maps the scene gives
(base colour, metallic-roughness, normal, occlusion, emissive; alpha MASK
and doubleSided where the scene asks), PNG textures in the binary chunk
(encoded here with zlib, lossless), one sampler per wrap pair, and the
node tree.

glTF extensions pass through as the scene gives them, written verbatim:
a material's or a node's "extensions" (e.g. KHR_materials_clearcoat, or
{"KHR_lights_punctual": {"light": 0}} on a node), the top level's
"extensions" (e.g. the KHR_lights_punctual light list) and
"extensions_used" (as extensionsUsed). A texture index inside them is a
position in scene["textures"], as the other slots' are. A scene without
them writes no extension key.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np


def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 4) u8 -> an RGBA8 PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 4)], 1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


class _Blob:
    def __init__(self):
        self.parts = []
        self.size = 0
        self.views = []

    def add(self, data: bytes) -> int:
        pad = (-self.size) % 4
        if pad:
            self.parts.append(b"\x00" * pad)
            self.size += pad
        self.views.append({"buffer": 0, "byteOffset": self.size, "byteLength": len(data)})
        self.parts.append(data)
        self.size += len(data)
        return len(self.views) - 1


def write_glb(path: str, scene: dict) -> str:
    blob = _Blob()
    accessors = []

    def accessor(arr, kind):
        arr = np.ascontiguousarray(arr)
        comp = {np.dtype(np.float32): 5126, np.dtype(np.uint32): 5125}[arr.dtype]
        acc = {"bufferView": blob.add(arr.tobytes()), "componentType": comp,
               "count": int(arr.shape[0]), "type": kind}
        if kind == "VEC3":
            acc["min"] = arr.min(0).tolist()
            acc["max"] = arr.max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    prims = []
    for p in scene["prims"]:
        prims.append({"attributes": {
            "POSITION": accessor(np.asarray(p["pos"], np.float32), "VEC3"),
            "NORMAL": accessor(np.asarray(p["normal"], np.float32), "VEC3"),
            "TEXCOORD_0": accessor(np.asarray(p["uv"], np.float32), "VEC2")},
            "indices": accessor(np.asarray(p["idx"], np.uint32), "SCALAR"),
            "material": int(p["material"])})
    samplers, textures, images = [], [], []
    for t in scene["textures"]:
        key = {"wrapS": int(t["wrap_s"]), "wrapT": int(t["wrap_t"])}
        if key not in samplers:
            samplers.append(key)
        images.append({"bufferView": blob.add(png_bytes(t["image"])), "mimeType": "image/png"})
        textures.append({"source": len(images) - 1, "sampler": samplers.index(key)})
    materials = []
    for m in scene["materials"]:
        pbr = {"baseColorFactor": [float(c) for c in m["base"]],
               "metallicFactor": float(m["metallic"]), "roughnessFactor": float(m["roughness"])}
        if m.get("albedo", -1) >= 0:
            pbr["baseColorTexture"] = {"index": int(m["albedo"])}
        if m.get("mr", -1) >= 0:
            pbr["metallicRoughnessTexture"] = {"index": int(m["mr"])}
        mat = {"pbrMetallicRoughness": pbr}
        if m.get("normal", -1) >= 0:
            mat["normalTexture"] = {"index": int(m["normal"]),
                                    "scale": float(m.get("normal_scale", 1.0))}
        if m.get("occlusion", -1) >= 0:
            mat["occlusionTexture"] = {"index": int(m["occlusion"]), "strength": 1.0}
        if m.get("emissive", -1) >= 0:
            mat["emissiveTexture"] = {"index": int(m["emissive"])}
        if "emissive_factor" in m:
            mat["emissiveFactor"] = [float(c) for c in m["emissive_factor"]]
        if "mask_cutoff" in m:
            mat["alphaMode"] = "MASK"
            mat["alphaCutoff"] = float(m["mask_cutoff"])
        if m.get("double_sided", False):
            mat["doubleSided"] = True
        if "extensions" in m:
            mat["extensions"] = m["extensions"]
        materials.append(mat)
    nodes = []
    for nd in scene["nodes"]:
        node = {"translation": [float(v) for v in nd["translation"]],
                "rotation": [float(v) for v in nd["rotation"]]}
        if nd["mesh"] >= 0:
            node["mesh"] = int(nd["mesh"])
        if nd["children"]:
            node["children"] = [int(c) for c in nd["children"]]
        if "extensions" in nd:
            node["extensions"] = nd["extensions"]
        nodes.append(node)
    doc = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": list(scene["roots"])}],
           "nodes": nodes, "meshes": [{"primitives": prims}], "materials": materials,
           "accessors": accessors, "bufferViews": blob.views}
    if textures:
        doc.update(textures=textures, samplers=samplers, images=images)
    if "extensions_used" in scene:
        doc["extensionsUsed"] = list(scene["extensions_used"])
    if "extensions" in scene:
        doc["extensions"] = scene["extensions"]
    data = b"".join(blob.parts)
    data += b"\x00" * ((-len(data)) % 4)
    doc["buffers"] = [{"byteLength": len(data)}]
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(data)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(data), 0x004E4942) + data)
    return path
