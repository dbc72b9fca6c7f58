"""The reference's scene: world-space triangles, materials and textures,
worked out from the scene dict the benchmark generated (not from the
file the program reads, nor from anything the program built).

What a glTF loader does to such a scene is part of its semantics and is
done again here: normals through the 10:10:10:2 tangent-space codec (a
file without tangents gets the codec's zero-angle tangent), the Y-up ->
Z-up basis at the roots, node transforms accumulated parents first,
normals by the inverse transpose, base-colour and emissive textures
decoded from sRGB, the others (normal, metallic-roughness) read as u8 / 255,
all kept at half precision.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

Y_UP_TO_Z_UP = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
WRAP = {10497: 0, 33071: 1, 33648: 2}  # glTF sampler code -> repeat, clamp, mirror
OPAQUE, MASK = 0, 1


# -- the tangent-space codec --------------------------------------------------

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


def quantize_normals(normal):
    """Normals through the 10:10:10:2 codec with no tangent (tangent angle
    bits 0, winding +1): (normal (V, 3), tangent (V, 4)) as decoded."""
    en = np.clip(0.5 * _encode_octahedral(normal) + 0.5, 0.0, 1.0)
    qn = np.floor(en * 1023.0 + 0.5)
    n2 = _decode_octahedral(2.0 * (qn / 1023.0) - 1.0)
    ct, cb = _basis(n2)
    dec_angle = 2 * np.pi * (np.zeros(normal.shape[:-1]) / 1023.0)
    t_dec = np.cos(dec_angle)[..., None] * ct + np.sin(dec_angle)[..., None] * cb
    w = np.ones(normal.shape[:-1])
    return n2.astype(np.float32), np.concatenate([t_dec, w[..., None]], -1).astype(np.float32)


# -- node transforms ----------------------------------------------------------

def trs_matrix(t, r):
    """Translation and xyzw quaternion (unit scale) -> row-major 4x4 f32."""
    t = np.asarray(t, np.float32)[None]
    r = np.asarray(r, np.float32)[None]
    x, y, z, w = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    rot = np.empty((1, 3, 3), np.float32)
    rot[..., 0, 0] = 1 - 2 * (y * y + z * z)
    rot[..., 0, 1] = 2 * (x * y - z * w)
    rot[..., 0, 2] = 2 * (x * z + y * w)
    rot[..., 1, 0] = 2 * (x * y + z * w)
    rot[..., 1, 1] = 1 - 2 * (x * x + z * z)
    rot[..., 1, 2] = 2 * (y * z - x * w)
    rot[..., 2, 0] = 2 * (x * z - y * w)
    rot[..., 2, 1] = 2 * (y * z + x * w)
    rot[..., 2, 2] = 1 - 2 * (x * x + y * y)
    m = np.zeros((1, 4, 4), np.float32)
    m[..., :3, :3] = rot * np.ones((1, 3), np.float32)[..., None, :]
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m[0]


def mesh_instances(scene):
    """[(mesh, global 4x4 f32)] in depth-first order from the roots."""
    nodes = scene["nodes"]
    out = []
    stack = [(r, Y_UP_TO_Z_UP) for r in reversed(scene["roots"])]
    while stack:
        i, parent = stack.pop()
        g = parent @ trs_matrix(nodes[i]["translation"], nodes[i]["rotation"])
        if nodes[i]["mesh"] >= 0:
            out.append((nodes[i]["mesh"], g))
        stack.extend((c, g) for c in reversed(nodes[i]["children"]))
    return out


def _fma32(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _matvec3(m, v):
    zero = torch.zeros(v.shape[:1], dtype=torch.float32, device=v.device)
    out = []
    for i in range(3):
        acc = zero
        for j in range(3):
            acc = _fma32(m[:, i, j], v[:, j], acc)
        out.append(acc)
    return torch.stack(out, -1)


def _unit(v):
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    n = torch.sqrt(_fma32(z, z, _fma32(y, y, x * x)))
    return v / torch.clamp(n, min=1e-20)[:, None]


# -- the scene ----------------------------------------------------------------

class World(NamedTuple):
    rows: Any         # (T, 3, 12) f32: per corner pos3 nrm3 tan4 uv2
    material: Any     # (T,) i64
    p0: np.ndarray    # (T, 3) f32 host copies for the tree
    p1: np.ndarray
    p2: np.ndarray


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


class Textures(NamedTuple):
    texels: Any       # (N, 4) f16 linear, every texture's level 0 flat
    base: Any         # (K,) i64 first texel
    width: Any        # (K,) i64
    height: Any
    wrap_s: Any       # (K,) i64 0 repeat, 1 clamp, 2 mirror
    wrap_t: Any


def build_world(scene, device) -> World:
    rows, mats = [], []
    for mesh, g in mesh_instances(scene):
        assert mesh == 0, "the scene dicts hold one mesh"
        m = torch.as_tensor(g, device=device)
        nm = torch.as_tensor(np.transpose(np.linalg.inv(g[None]), (0, 2, 1)).astype(np.float32)[0],
                             device=device)
        for p in scene["prims"]:
            nrm, tan = quantize_normals(np.asarray(p["normal"], np.float32))
            pos = torch.as_tensor(np.asarray(p["pos"], np.float32), device=device)
            nrm = torch.as_tensor(nrm, device=device)
            tan = torch.as_tensor(tan, device=device)
            v = pos.shape[0]
            mm = m.expand(v, 4, 4)
            nn = nm.expand(v, 4, 4)
            wpos = _matvec3(mm[:, :3, :3], pos) + mm[:, :3, 3]
            wnrm = _unit(_matvec3(nn[:, :3, :3], nrm))
            wtan = torch.cat([_unit(_matvec3(mm[:, :3, :3], tan[:, :3])), tan[:, 3:4]], -1)
            uv = torch.as_tensor(np.asarray(p["uv"], np.float32), device=device)
            vrow = torch.cat([wpos, wnrm, wtan, uv], 1)
            idx = torch.as_tensor(np.asarray(p["idx"], np.int64).reshape(-1, 3), device=device)
            rows.append(vrow[idx])
            mats.append(torch.full((idx.shape[0],), int(p["material"]), dtype=torch.int64,
                                   device=device))
    rows = torch.cat(rows)
    host = rows[:, :, 0:3].cpu().numpy()
    return World(rows=rows, material=torch.cat(mats), p0=host[:, 0], p1=host[:, 1],
                 p2=host[:, 2])


def build_materials(scene, device) -> Materials:
    ms = scene["materials"]

    def f32(key, default=None):
        return torch.as_tensor(np.asarray([m.get(key, default) for m in ms], np.float32),
                               device=device)

    def tex(key):
        return torch.as_tensor([int(m.get(key, -1)) for m in ms], device=device)

    return Materials(
        base=torch.as_tensor(np.asarray([m["base"] for m in ms], np.float32), device=device),
        metallic=f32("metallic"), roughness=f32("roughness"),
        alpha_mode=torch.as_tensor([MASK if "mask_cutoff" in m else OPAQUE for m in ms],
                                   device=device),
        cutoff=torch.as_tensor(np.asarray([m.get("mask_cutoff", 0.0) for m in ms], np.float32),
                               device=device),
        albedo=tex("albedo"), mr=tex("mr"), normal=tex("normal"),
        normal_scale=f32("normal_scale", 1.0), emissive=f32("emissive_factor", [0.0] * 3),
        emissive_tex=tex("emissive"))


def decode_u8(img, srgb: bool):
    """(H, W, 4) u8 -> linear f16: u8 / 255, and with srgb the RGB decoded
    from sRGB (alpha as is)."""
    lin = np.asarray(img).astype(np.float32) / 255.0
    if srgb:
        c = lin[..., :3]
        a = 0.055
        lin[..., :3] = np.where(c <= 0.04045, c / 12.92, ((c + a) / (1 + a)) ** 2.4)
    return lin.astype(np.float16)


def srgb_textures(scene) -> set:
    """Ids of the textures that hold colour (base colour, emissive): the
    glTF convention decodes those from sRGB. A texture serves one kind."""
    colour = {m.get(k, -1) for m in scene["materials"] for k in ("albedo", "emissive")}
    data = {m.get(k, -1) for m in scene["materials"] for k in ("mr", "normal", "occlusion")}
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
