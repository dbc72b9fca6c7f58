"""Mesh pieces the scene generators share (host numpy).

Frozen copies of the program's procedural helpers (uv sphere, subdivided
quad, open cylinder, grid indices), so the benchmark's scenes do not move
when the program's generators change. A scene is a plain dict:

    {"prims": [{"pos", "normal", "uv", "idx", "material"}, ...],   # one mesh
     "materials": [{"base", "metallic", "roughness", "albedo",
                    "mask_cutoff" (optional), "double_sided"}, ...],
     "textures": [{"image": (H, W, 4) u8, "wrap_s", "wrap_t"}, ...],
     "nodes": [{"mesh", "translation", "rotation", "children"}, ...],
     "roots": [...]}

Materials and textures are indexed from 0 as in the glTF document; wrap
modes are glTF sampler codes (10497 REPEAT, 33071 CLAMP_TO_EDGE).
"""

from __future__ import annotations

import numpy as np

REPEAT = 10497
CLAMP = 33071


def uv_sphere(n_lat=32, n_lon=64, radius=0.5):
    lat = np.linspace(0, np.pi, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    d = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1)
    verts = (radius * d).reshape(-1, 3)
    uvs = np.stack([np.broadcast_to(np.arange(n_lon) / n_lon, th.shape),
                    np.broadcast_to((np.arange(n_lat) / (n_lat - 1))[:, None], th.shape)], -1)
    i, j = np.meshgrid(np.arange(n_lat - 1), np.arange(n_lon), indexing="ij")
    a = i * n_lon + j
    b = i * n_lon + (j + 1) % n_lon
    c = (i + 1) * n_lon + j
    e = (i + 1) * n_lon + (j + 1) % n_lon
    idx = np.stack([a, b, c, b, e, c], -1).reshape(-1)  # CCW seen from outside
    return (verts.astype(np.float32), d.reshape(-1, 3).astype(np.float32),
            uvs.reshape(-1, 2).astype(np.float32), idx.astype(np.uint32))


def grid_idx(nu, nv):
    """Two triangles per cell of an (nu + 1) x (nv + 1) vertex grid (u major)."""
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).reshape(-1)
    b = ((i + 1) * (nv + 1) + j).reshape(-1)
    c = ((i + 1) * (nv + 1) + j + 1).reshape(-1)
    d = (i * (nv + 1) + j + 1).reshape(-1)
    return np.stack([a, b, c, a, c, d], 1).reshape(-1).astype(np.uint32)


def quad_grid(origin, ax_u, ax_v, nu, nv):
    """Subdivided quad origin + u*ax_u + v*ax_v, u, v in [0, 1]."""
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
    return p.reshape(-1, 3), n.reshape(-1, 3), uv.reshape(-1, 2), grid_idx(nu, nv)


def cylinder(center, radius, height, n_seg, n_h):
    """Open cylinder around +Z."""
    center = np.asarray(center, np.float32)
    th = np.linspace(0, 2 * np.pi, n_seg + 1, dtype=np.float32)
    z = np.linspace(0, height, n_h + 1, dtype=np.float32)
    tt, zz = np.meshgrid(th, z, indexing="ij")
    p = np.stack([center[0] + radius * np.cos(tt), center[1] + radius * np.sin(tt),
                  center[2] + zz], -1).astype(np.float32)
    n = np.stack([np.cos(tt), np.sin(tt), np.zeros_like(tt)], -1).astype(np.float32)
    uv = np.stack([tt / (2 * np.pi), zz / height], -1).astype(np.float32)
    return p.reshape(-1, 3), n.reshape(-1, 3), uv.reshape(-1, 2), grid_idx(n_seg, n_h)


def concat_parts(parts):
    """(pos, normal, uv, idx) parts -> one primitive, indices offset."""
    base, idxs = 0, []
    for part in parts:
        idxs.append(part[3] + base)
        base += part[0].shape[0]
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(3)) + (
        np.concatenate(idxs).astype(np.uint32),)


def triangle_count(scene) -> int:
    return int(sum(len(p["idx"]) // 3 for p in scene["prims"]))
