"""The reference's scene: world-space triangles, materials, textures and
punctual lights, worked out from the scene dict the benchmark generated
(not from the file the program reads, nor from anything the program
built).

What a glTF loader does to such a scene is part of its semantics and is
done again here (the triangles and the texture decode by
perfbench/reference/world.py's functions, which this module uses): normals through the 10:10:10:2 tangent-space codec (a
file without tangents gets the codec's zero-angle tangent), the Y-up ->
Z-up basis at the roots, node transforms accumulated parents first,
normals by the inverse transpose, base-colour, emissive and sheen-colour
textures decoded from sRGB, the others (normal, metallic-roughness,
clearcoat) read as u8 / 255, all kept at half precision. The material
extensions read from a material's "extensions" (the dict the GLB carries
verbatim): KHR_materials_clearcoat (factor, roughness factor, map),
KHR_materials_sheen (colour factor, roughness factor, colour map),
KHR_materials_transmission (factor), KHR_materials_ior, and
KHR_texture_transform on the extension maps' textureInfo (rotation,
offset, scale). The lights: KHR_lights_punctual's list at the top level,
placed by the nodes that name them, in node order, at the node's global
translation and pointing down its -Z axis (the inverse transpose of its
global transform, normalized), range as the distance cutoff (0: none).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..reference.world import (
    MASK,
    OPAQUE,
    WRAP,
    Y_UP_TO_Z_UP,
    Textures,
    World,
    build_world,
    decode_u8,
    trs_matrix,
)

# -- the scene ----------------------------------------------------------------


class Materials(NamedTuple):
    base: Any         # (M, 4)
    metallic: Any     # (M,)
    roughness: Any
    alpha_mode: Any   # (M,) i64
    cutoff: Any
    albedo: Any       # (M,) i64 texture id or -1
    mr: Any           # (M,) i64 metallic-roughness texture id or -1
    normal: Any       # (M,) i64 normal texture id or -1
    normal_scale: Any  # (M,)
    emissive: Any     # (M, 3) factor
    emissive_tex: Any  # (M,) i64 texture id or -1
    ior: Any          # (M,)
    clearcoat: Any    # (M,) factor
    clearcoat_roughness: Any  # (M,) factor
    clearcoat_tex: Any  # (M,) i64 texture id or -1 (its R channel)
    sheen_color: Any  # (M, 3) factor
    sheen_roughness: Any  # (M,) factor
    sheen_tex: Any    # (M,) i64 sheen-colour texture id or -1
    sheen_xform: Any  # (rotation (M,), offset (M, 2), scale (M, 2)) of the sheen map's uv
    transmission: Any  # (M,) factor


class Lights(NamedTuple):
    type: Any         # (L,) i64: 0 point, 1 spot, 2 directional
    position: Any     # (L, 3)
    direction: Any    # (L, 3) unit
    color: Any        # (L, 3)
    intensity: Any    # (L,)
    cutoff: Any       # (L,) range, 0 for none
    inner: Any        # (L,) spot cone angles
    outer: Any


LIGHT_TYPES = {"point": 0, "spot": 1, "directional": 2}


def _ext(m, name):
    return m.get("extensions", {}).get(name, {})


def _ext_tex(info):
    """(texture id or -1, (rotation, offset, scale)) of a textureInfo."""
    if not isinstance(info, dict) or "index" not in info:
        return -1, (0.0, [0.0, 0.0], [1.0, 1.0])
    xf = info.get("extensions", {}).get("KHR_texture_transform", {})
    return int(info["index"]), (xf.get("rotation", 0.0), xf.get("offset", [0.0, 0.0]),
                                xf.get("scale", [1.0, 1.0]))


def build_materials(scene, device) -> Materials:
    ms = scene["materials"]

    def f32(key, default=None):
        return torch.as_tensor(np.asarray([m.get(key, default) for m in ms], np.float32),
                               device=device)

    def tex(key):
        return torch.as_tensor([int(m.get(key, -1)) for m in ms], device=device)

    def ext(name, key, default):
        return torch.as_tensor(np.asarray([_ext(m, name).get(key, default) for m in ms],
                                          np.float32), device=device)

    def ext_tex(name, key):
        return [_ext_tex(_ext(m, name).get(key)) for m in ms]

    cc = ext_tex("KHR_materials_clearcoat", "clearcoatTexture")
    sh = ext_tex("KHR_materials_sheen", "sheenColorTexture")
    sheen_xform = tuple(torch.as_tensor(np.asarray([x[1][k] for x in sh], np.float32),
                                        device=device) for k in range(3))
    return Materials(
        ior=ext("KHR_materials_ior", "ior", 1.5),
        clearcoat=ext("KHR_materials_clearcoat", "clearcoatFactor", 0.0),
        clearcoat_roughness=ext("KHR_materials_clearcoat", "clearcoatRoughnessFactor", 0.0),
        clearcoat_tex=torch.as_tensor([x[0] for x in cc], device=device),
        sheen_color=ext("KHR_materials_sheen", "sheenColorFactor", [0.0, 0.0, 0.0]),
        sheen_roughness=ext("KHR_materials_sheen", "sheenRoughnessFactor", 0.0),
        sheen_tex=torch.as_tensor([x[0] for x in sh], device=device),
        sheen_xform=sheen_xform,
        transmission=ext("KHR_materials_transmission", "transmissionFactor", 0.0),
        base=torch.as_tensor(np.asarray([m["base"] for m in ms], np.float32), device=device),
        metallic=f32("metallic"), roughness=f32("roughness"),
        alpha_mode=torch.as_tensor([MASK if "mask_cutoff" in m else OPAQUE for m in ms],
                                   device=device),
        cutoff=torch.as_tensor(np.asarray([m.get("mask_cutoff", 0.0) for m in ms], np.float32),
                               device=device),
        albedo=tex("albedo"), mr=tex("mr"), normal=tex("normal"),
        normal_scale=f32("normal_scale", 1.0), emissive=f32("emissive_factor", [0.0] * 3),
        emissive_tex=tex("emissive"))


def srgb_textures(scene) -> set:
    """Ids of the textures that hold colour (base colour, emissive, sheen
    colour): the glTF convention decodes those from sRGB. A texture serves
    one kind."""
    ms = scene["materials"]
    colour = {m.get(k, -1) for m in ms for k in ("albedo", "emissive")}
    colour |= {_ext_tex(_ext(m, "KHR_materials_sheen").get("sheenColorTexture"))[0] for m in ms}
    data = {m.get(k, -1) for m in ms for k in ("mr", "normal", "occlusion")}
    data |= {_ext_tex(_ext(m, "KHR_materials_clearcoat").get("clearcoatTexture"))[0] for m in ms}
    assert not (colour & data) - {-1}, "a texture read both as colour and as data"
    return colour - {-1}


def build_textures(scene, device) -> Textures:
    flat, base, w, h, ws, wt = [], [], [], [], [], []
    n = 0
    srgb = srgb_textures(scene)
    for i, t in enumerate(scene["textures"]):
        img = decode_u8(t["image"], i in srgb)
        flat.append(img.reshape(-1, 4))
        base.append(n)
        h.append(img.shape[0])
        w.append(img.shape[1])
        ws.append(WRAP[int(t["wrap_s"])])
        wt.append(WRAP[int(t["wrap_t"])])
        n += img.shape[0] * img.shape[1]
    if not flat:
        flat = [np.ones((1, 4), np.float16)]

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64).reshape(-1), device=device)

    return Textures(texels=torch.as_tensor(np.concatenate(flat), device=device), base=i64(base),
                    width=i64(w), height=i64(h), wrap_s=i64(ws), wrap_t=i64(wt))


def global_transforms(scene) -> dict:
    """{node: global 4x4 f32} of every node under the roots."""
    nodes = scene["nodes"]
    out = {}
    stack = [(r, Y_UP_TO_Z_UP) for r in reversed(scene["roots"])]
    while stack:
        i, parent = stack.pop()
        out[i] = parent @ trs_matrix(nodes[i]["translation"], nodes[i]["rotation"])
        stack.extend((c, out[i]) for c in reversed(nodes[i]["children"]))
    return out


def build_lights(scene, device) -> Lights:
    """The punctual lights of the nodes that name one, in node order."""
    defs = scene.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
    tf = global_transforms(scene)
    named = [(i, nd["extensions"]["KHR_lights_punctual"]["light"])
             for i, nd in enumerate(scene["nodes"])
             if "KHR_lights_punctual" in nd.get("extensions", {}) and i in tf]
    g = np.stack([tf[i] for i, _ in named]).astype(np.float32) if named else np.zeros(
        (0, 4, 4), np.float32)
    ntf = np.transpose(np.linalg.inv(g), (0, 2, 1))
    d = ntf[:, :3, :3] @ np.asarray([0.0, 0.0, -1.0], np.float32)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
    ls = [defs[k] for _, k in named]

    def f32(values, shape):
        return torch.as_tensor(np.asarray(values, np.float32).reshape(shape), device=device)

    n = len(ls)
    return Lights(
        type=torch.as_tensor([LIGHT_TYPES[li.get("type", "point")] for li in ls],
                             dtype=torch.int64, device=device),
        position=f32(g[:, :3, 3], (n, 3)), direction=f32(d, (n, 3)),
        color=f32([li.get("color", [1.0, 1.0, 1.0]) for li in ls], (n, 3)),
        intensity=f32([li.get("intensity", 1.0) for li in ls], (n,)),
        cutoff=f32([li.get("range", 0.0) for li in ls], (n,)),
        inner=f32([li.get("spot", {}).get("innerConeAngle", 0.0) for li in ls], (n,)),
        outer=f32([li.get("spot", {}).get("outerConeAngle", np.pi / 4.0) for li in ls], (n,)))
