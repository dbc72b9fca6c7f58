"""Skinning + morph targets on torch (port of gltf_renderer_tpu/anim/skinning.py,
itself a port of Skin.cs.hlsl).

The reference dispatches a 64-wide compute shader per dynamic primitive
(GpuSkin.cpp:57-118) with at most 4 morph targets (top-weight selection,
Renderer.cpp:423-444) and 4-bone matrix-palette skinning. `skin_primitive`
runs one primitive's vertex range as a few tensor ops on the pools' device;
`DynamicMeshState` keeps the skinned pools there and runs the JAX
package's per-(node, primitive) loop. The skinned tangent space goes back
through the 10:10:10:2 codec, as the reference's EncodeTangentSpace output
does (Skin.cs.hlsl:136).

Sums run in index order with each op rounded, where the JAX package's
jitted CPU build contracts multiply-adds: positions and normals agree to
a few float32 ulps, and after the codec a vertex may sit one codec level
apart (tests/test_torch_anim.py states the bounds).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from gltf_renderer_tpu_torch.device import resolve
from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.utils.math import (
    decode_tangent_space,
    encode_tangent_space,
    normalize,
    unpack_r10g10b10a2,
)

MAX_SIMULTANEOUS_MORPH_TARGETS = 4  # Config.h:23


def select_top_morph_targets(weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Top-K positive weights (Renderer.cpp:423-444). Returns (indices, weights)
    padded to MAX_SIMULTANEOUS_MORPH_TARGETS with weight 0."""
    idx = [i for i, w in enumerate(weights) if w > 0.0]
    idx.sort(key=lambda i: -weights[i])
    idx = idx[:MAX_SIMULTANEOUS_MORPH_TARGETS]
    out_i = np.zeros(MAX_SIMULTANEOUS_MORPH_TARGETS, np.int32)
    out_w = np.zeros(MAX_SIMULTANEOUS_MORPH_TARGETS, np.float32)
    for k, i in enumerate(idx):
        out_i[k] = i
        out_w[k] = float(weights[i])
    return out_i, out_w


def compute_bones(node_global: np.ndarray, skin: T.Skin,
                  mesh_node_global: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Bone palettes (Renderer.cpp:412-417), host numpy:
    bone = inverse(mesh_node.global) @ joint.global @ inverse_bind, and the
    inverse transpose of its 3x3 for normals."""
    inv_node = np.linalg.inv(mesh_node_global)
    bones = inv_node[None] @ node_global[skin.joints] @ skin.inverse_bind
    it = bones.copy()
    it[:, :3, :3] = np.transpose(np.linalg.inv(bones[:, :3, :3]), (0, 2, 1))
    it[:, :3, 3] = 0.0
    return bones.astype(np.float32), it.astype(np.float32)


def _weighted_sum(w, x):
    """sum_k w[..., k] * x[..., k, :] in index order (k is dim 1)."""
    out = w[:, 0] * x[:, 0]
    for k in range(1, x.shape[1]):
        out = out + w[:, k] * x[:, k]
    return out


def _matvec3(m, v):
    """(V, 3, 3) @ (V, 3) -> (V, 3), each row summed in index order."""
    return m[:, :, 0] * v[:, 0:1] + m[:, :, 1] * v[:, 1:2] + m[:, :, 2] * v[:, 2:3]


def _select(flag, a, b):
    """a where flag, else b: flag a Python bool, or a (V,) bool tensor."""
    if isinstance(flag, torch.Tensor):
        return torch.where(flag[:, None], a, b)
    return a if flag else b


def skin_primitive(positions, normals, tangents, joints, weights, bones, bones_it,
                   morph_pos, morph_nrm, morph_tan, morph_weights, has_skin, has_ts):
    """Skin.cs.hlsl main:53-136 on a run of vertices.

    positions/normals (V, 3), tangents (V, 4), joints (V, 4) palette ids,
    weights (V, 4), bones/bones_it (B, 4, 4), morph_* (K, V, 3) selected
    target deltas, morph_weights (K,) for one primitive or (K, V) per
    vertex; has_skin / has_ts a bool for one primitive or a (V,) bool
    tensor per vertex. Returns (position, normal, tangent)."""
    mw = morph_weights.reshape(morph_weights.shape[0], -1, 1)
    position = positions + _ksum(mw * morph_pos)
    normal = normals + _ksum(mw * morph_nrm)
    tangent_xyz = tangents[:, :3] + _ksum(mw * morph_tan)
    if has_skin is not False:
        w = weights[..., None, None]
        blend = _weighted_sum(w, bones[joints])        # (V, 4, 4)
        blend_it = _weighted_sum(w, bones_it[joints])
        position = _select(has_skin, _matvec3(blend[:, :3, :3], position) + blend[:, :3, 3],
                           position)
        normal = _select(has_skin, _matvec3(blend_it[:, :3, :3], normal), normal)
        tangent_xyz = _select(has_skin, _matvec3(blend[:, :3, :3], tangent_xyz), tangent_xyz)
    n_unit = normalize(normal)
    t_unit = torch.cat([normalize(tangent_xyz), tangents[:, 3:4]], -1)
    if has_ts is False:
        return position, n_unit, t_unit
    n_q, t_q = decode_tangent_space(unpack_r10g10b10a2(encode_tangent_space(n_unit, t_unit)))
    return position, _select(has_ts, n_q, n_unit), _select(has_ts, t_q, t_unit)


def _ksum(x):
    """Sum over the leading (morph target) axis in index order."""
    out = x[0]
    for k in range(1, x.shape[0]):
        out = out + x[k]
    return out


class DynamicMeshState:
    """The skinned / morphed vertex pools of one scene, on `device`.

    Replaces DynamicMesh double-buffering (Mesh.cpp:221-279): full-pool
    shaped positions, normals and tangents whose dynamic primitives'
    ranges `update` rewrites each frame, for flatten.build_world_geometry's
    dynamic pools.

    The JAX package runs `skin_primitive` once per (node, primitive); here
    one call skins every dynamic vertex, with per-vertex palette ids, morph
    weights and flags. Each vertex sees the same operations in the same
    order as in the per-primitive loop, so the pools are the same bits
    (tests/test_torch_anim.py holds the two equal). Where two nodes share a
    mesh, the loop's last write wins; so does the last instance here. The
    rest pools, joints, weights, morph deltas and the gather maps are
    uploaded once; a frame uploads its bone palettes and morph weights in
    one array and its morph selections in another."""

    def __init__(self, scene: T.Scene, device="cuda"):
        self.scene = scene
        self.device = dev = resolve(device)
        pools, prim = scene.pools, scene.primitives

        def up(a, dtype=None):
            return torch.as_tensor(np.asarray(a, dtype), device=dev)

        self.positions, self.normals, self.tangents = (
            up(x).clone() for x in (pools.positions, pools.normals, pools.tangents))
        # (node, prim) pairs needing skinning/morphing, static per scene.
        self.dynamic_instances: List[Tuple[int, int]] = []
        for node_id, node in enumerate(scene.nodes):
            if node.mesh < 0:
                continue
            prims = scene.meshes[node.mesh].primitives
            has_morph = any(int(prim.morph_count[p]) > 0 for p in prims)
            if node.skin >= 0 or has_morph or (node.weights is not None):
                self.dynamic_instances.extend((node_id, p) for p in prims)
        last = {p: i for i, (_, p) in enumerate(self.dynamic_instances)}
        self._kept = [self.dynamic_instances[i] for i in sorted(last.values())]
        cols = {k: [] for k in ("v", "inst", "local", "joint_off", "skin", "ts")}
        n_bones = 0
        for i, (node_id, p) in enumerate(self._kept):
            vo, vc = int(prim.vertex_offset[p]), int(prim.vertex_count[p])
            skin = scene.nodes[node_id].skin
            cols["v"].append(np.arange(vo, vo + vc))
            cols["inst"].append(np.full(vc, i))
            cols["local"].append(np.arange(vc))
            size = len(scene.skins[skin].joints) if skin >= 0 else 1
            joints = np.clip(np.asarray(pools.joints[vo:vo + vc], np.int64), 0, size - 1)
            cols["joint_off"].append(joints + n_bones if skin >= 0 else np.zeros_like(joints))
            n_bones += size if skin >= 0 else 0
            cols["skin"].append(np.full(vc, skin >= 0))
            cols["ts"].append(np.full(vc, bool(prim.has_tangent_space[p])))
        cat = {k: np.concatenate(v) if v else np.zeros(0, np.int64) for k, v in cols.items()}
        self._v = up(cat["v"], np.int64)
        self._inst = up(cat["inst"], np.int64)
        # Non-skinned vertices read the identity palette appended after the
        # skinned instances'; the per-primitive loop gives them one identity.
        joints = cat["joint_off"].reshape(-1, 4)
        skinned = cat["skin"].astype(bool)
        joints[~skinned] = n_bones
        self._joints = up(joints, np.int64)
        self._weights = up(pools.weights)[self._v]
        self._has_skin = up(skinned)
        self._has_ts = up(cat["ts"].astype(bool))
        self._rest = tuple(up(x)[self._v] for x in (pools.positions, pools.normals,
                                                    pools.tangents))
        # Morph deltas with one zero row appended: a primitive without
        # targets reads it, as the loop's zero deltas.
        self._morph = tuple(torch.cat([up(x), torch.zeros((1, 3), device=dev)])
                            for x in (pools.morph_pos, pools.morph_normal,
                                      pools.morph_tangent))
        zero_row = len(pools.morph_pos)
        mo = np.asarray([int(prim.morph_offset[p]) for _, p in self._kept], np.int64)
        vc = np.asarray([int(prim.vertex_count[p]) for _, p in self._kept], np.int64)
        has_morph = np.asarray([int(prim.morph_count[p]) > 0 for _, p in self._kept], bool)
        inst = cat["inst"].astype(np.int64)
        self._morph_base = up(np.where(has_morph[inst], mo[inst] + cat["local"], zero_row),
                              np.int64)
        self._morph_stride = up(np.where(has_morph[inst], vc[inst], 0), np.int64)

    def update(self, node_global: np.ndarray, pose_weights: Dict[int, np.ndarray]):
        """Skin every dynamic primitive (PerformSkinning port) into the pools."""
        scene = self.scene
        prim = scene.primitives
        k = MAX_SIMULTANEOUS_MORPH_TARGETS
        palettes, palettes_it = [], []
        sel_i = np.zeros((len(self._kept), k), np.int64)
        sel_w = np.zeros((len(self._kept), k), np.float32)
        for i, (node_id, p) in enumerate(self._kept):
            n_targets = int(prim.morph_count[p])
            weights = pose_weights.get(node_id)
            if weights is not None and len(weights) and n_targets:
                sel_i[i], sel_w[i] = select_top_morph_targets(weights[:n_targets])
            skin = scene.nodes[node_id].skin
            if skin >= 0:
                bones, bones_it = compute_bones(node_global, scene.skins[skin],
                                                node_global[node_id])
                palettes.append(bones)
                palettes_it.append(bones_it)
        eye = np.eye(4, dtype=np.float32)[None]
        floats = np.concatenate([np.concatenate(palettes + [eye]).ravel(),
                                 np.concatenate(palettes_it + [eye]).ravel(), sel_w.ravel()])
        floats = torch.as_tensor(floats, device=self.device)
        n = 16 * (sum(len(b) for b in palettes) + 1)
        bones, bones_it = floats[:n].view(-1, 4, 4), floats[n:2 * n].view(-1, 4, 4)
        weights = floats[2 * n:].view(-1, k)[self._inst].T              # (K, V)
        sel = torch.as_tensor(sel_i, device=self.device)[self._inst].T  # (K, V)
        idx = self._morph_base + sel * self._morph_stride
        morph = [m[idx] for m in self._morph]                           # (K, V, 3) each
        pos, nrm, tan = skin_primitive(*self._rest, self._joints, self._weights, bones,
                                       bones_it, *morph, weights, self._has_skin,
                                       self._has_ts)
        self.positions[self._v] = pos
        self.normals[self._v] = nrm
        self.tangents[self._v] = tan
