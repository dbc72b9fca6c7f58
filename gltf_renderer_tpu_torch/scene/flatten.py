"""Scene flattening: node transforms, instance plan, world-space geometry.

Port of gltf_renderer_tpu/scene/flatten.py. World geometry has f32 rows
only; the hot path reads `tri_attr_rows`, one 64-wide row per triangle.
Matrix-vector products are written out term by term so their rounding
matches the reference's. A static scene's world is built once, on the host;
an animated frame's is built from the skinned pools on their device.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from gltf_renderer_tpu_torch.scene import types as T

# glTF Y-up -> renderer Z-up basis change (x, y, z)_gltf -> (x, -z, y)_world.
Y_UP_TO_Z_UP = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
)

# tri_rows flag bits (packed per-triangle word).
TRI_HAS_TS = 1
TRI_HAS_UV0 = 2
TRI_HAS_UV1 = 4
TRI_HAS_COLOR = 8
TRI_DOUBLE_SIDED = 16
TRI_ALPHA_SHIFT = 5


class WorldGeometry(NamedTuple):
    """World-space flattened geometry (same fields as the JAX package's)."""

    position: Any
    normal: Any
    tangent: Any
    uv0: Any
    uv1: Any
    color: Any
    tri_vertex: Any
    tri_material: Any
    tri_double_sided: Any
    tri_alpha_mode: Any
    tri_has_ts: Any
    tri_has_uv0: Any
    tri_has_uv1: Any
    tri_has_color: Any
    vertex_rows: Any = None     # (VW, 20) f32: pos3 nrm3 tan4 uv0_2 uv1_2 col4 pad2
    tri_rows: Any = None        # (TW, 8) i32: v0 v1 v2 material flagbits 0 0 0
    tri_attr_rows: Any = None   # (TW, 64) f32: v0row v1row v2row | material fbits (bitcast) pad2


def trs_to_matrix_np(t: np.ndarray, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(..., 3), (..., 4 xyzw), (..., 3) -> (..., 4, 4) row-major."""
    x, y, z, w = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    rot = np.empty(r.shape[:-1] + (3, 3), np.float32)
    rot[..., 0, 0] = 1 - 2 * (y * y + z * z)
    rot[..., 0, 1] = 2 * (x * y - z * w)
    rot[..., 0, 2] = 2 * (x * z + y * w)
    rot[..., 1, 0] = 2 * (x * y + z * w)
    rot[..., 1, 1] = 1 - 2 * (x * x + z * z)
    rot[..., 1, 2] = 2 * (y * z - x * w)
    rot[..., 2, 0] = 2 * (x * z - y * w)
    rot[..., 2, 1] = 2 * (y * z + x * w)
    rot[..., 2, 2] = 1 - 2 * (x * x + y * y)
    m = np.zeros(r.shape[:-1] + (4, 4), np.float32)
    m[..., :3, :3] = rot * s[..., None, :]
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def compute_global_transforms(scene, scene_id: Optional[int] = None, local_t=None,
                              local_r=None, local_s=None) -> np.ndarray:
    """Global node transforms (N, 4, 4), parents first; roots get the
    Y-up -> Z-up basis change (Gltf.cpp:1015-1041). local_t/r/s: a pose's
    node-local TRS (anim.animation.LocalPose), else the nodes' rest TRS.
    scene_id is accepted for the JAX signature's sake: every node gets its
    transform whichever scene is drawn."""
    n = scene.num_nodes()
    if local_t is None:
        local_t = np.stack([nd.translation for nd in scene.nodes]) if n else np.zeros((0, 3))
        local_r = np.stack([nd.rotation for nd in scene.nodes]) if n else np.zeros((0, 4))
        local_s = np.stack([nd.scale for nd in scene.nodes]) if n else np.zeros((0, 3))
    local = trs_to_matrix_np(np.asarray(local_t, np.float32), np.asarray(local_r, np.float32),
                             np.asarray(local_s, np.float32))
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in scene.topo_order:
        p = scene.nodes[i].parent
        parent_m = out[p] if p >= 0 else Y_UP_TO_Z_UP
        out[i] = parent_m @ local[i]
    return out


def normal_transforms(global_tf: np.ndarray) -> np.ndarray:
    """Inverse-transpose (Pathtracer.cpp:205)."""
    return np.transpose(np.linalg.inv(global_tf), (0, 2, 1)).astype(np.float32)


def _node_has_morph(scene, node_id: int) -> bool:
    node = scene.nodes[node_id]
    if node.weights is not None and len(node.weights) > 0:
        return True
    if node.mesh >= 0:
        mw = scene.meshes[node.mesh].weights
        if mw is not None and len(mw) > 0:
            return True
        return any(int(scene.primitives.morph_count[p]) > 0
                   for p in scene.meshes[node.mesh].primitives)
    return False


def build_instance_plan(scene, scene_id: Optional[int] = None) -> T.InstancePlan:
    """Unroll the scene traversal into static gather maps (host, load time)."""
    if scene_id is None:
        scene_id = scene.default_scene
    prim = scene.primitives
    mat = scene.materials
    v_maps, v_nodes, v_skinned = [], [], []
    tri_v, tri_m, tri_p, tri_ds, tri_am = [], [], [], [], []
    inst_node, inst_prim = [], []
    vw_off = 0
    order: List[int] = []
    stack = list(reversed(scene.scenes[scene_id])) if scene.scenes else []
    while stack:
        i = stack.pop()
        order.append(i)
        stack.extend(reversed(scene.nodes[i].children))
    for node_id in order:
        node = scene.nodes[node_id]
        if node.mesh < 0:
            continue
        mesh = scene.meshes[node.mesh]
        dynamic = node.skin >= 0 or _node_has_morph(scene, node_id)
        for p in mesh.primitives:
            vo = int(prim.vertex_offset[p])
            vc = int(prim.vertex_count[p])
            to = int(prim.tri_offset[p])
            tc = int(prim.tri_count[p])
            m = int(prim.material[p])
            v_maps.append(np.arange(vo, vo + vc, dtype=np.int32))
            v_nodes.append(np.full(vc, node_id, np.int32))
            v_skinned.append(np.full(vc, 1 if dynamic else 0, np.int32))
            tri_v.append(scene.pools.tri_vertex[to : to + tc] - vo + vw_off)
            tri_m.append(np.full(tc, m, np.int32))
            tri_p.append(np.full(tc, p, np.int32))
            ds = 1 if (int(mat.flags[m]) & T.MATERIAL_FLAG_DOUBLE_SIDED) else 0
            tri_ds.append(np.full(tc, ds, np.int32))
            tri_am.append(np.full(tc, int(mat.alpha_mode[m]), np.int32))
            inst_node.append(node_id)
            inst_prim.append(p)
            vw_off += vc

    def cat(lst, shape):
        return np.concatenate(lst, 0) if lst else np.zeros(shape, np.int32)

    return T.InstancePlan(
        vertex_map=cat(v_maps, (0,)), vertex_node=cat(v_nodes, (0,)),
        vertex_skinned=cat(v_skinned, (0,)), tri_vertex=cat(tri_v, (0, 3)),
        tri_material=cat(tri_m, (0,)), tri_prim=cat(tri_p, (0,)),
        tri_double_sided=cat(tri_ds, (0,)), tri_alpha_mode=cat(tri_am, (0,)),
        instance_node=np.asarray(inst_node, np.int32),
        instance_prim=np.asarray(inst_prim, np.int32),
    )


def plan_tri_flags(plan, primitives) -> dict:
    """Static per-world-triangle attribute flags (host)."""
    p = np.asarray(plan.tri_prim)
    return dict(
        tri_has_ts=np.asarray(primitives.has_tangent_space)[p].astype(np.int32),
        tri_has_uv0=np.asarray(primitives.has_uv0)[p].astype(np.int32),
        tri_has_uv1=np.asarray(primitives.has_uv1)[p].astype(np.int32),
        tri_has_color=np.asarray(primitives.has_color)[p].astype(np.int32),
    )


def _fma32(a, b, c):
    """f32 fused multiply-add (the f32 product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _matvec3(m, v):
    """(V, 3, 3) @ (V, 3) -> (V, 3), each row accumulated in index order as
    fused multiply-adds, the rounding of the reference's CPU build (XLA
    fuses its batched dot, from a +0 accumulator)."""
    zero = torch.zeros(v.shape[:1], dtype=torch.float32, device=v.device)
    out = []
    for i in range(3):
        acc = zero
        for j in range(3):
            acc = _fma32(m[:, i, j], v[:, j], acc)
        out.append(acc)
    return torch.stack(out, -1)


def _unit(v):
    """Normalise rows. The squared length accumulates as fused multiply-adds
    in index order, the rounding of the reference's CPU build (XLA fuses the
    squares of its norm reduction)."""
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    n = torch.sqrt(_fma32(z, z, _fma32(y, y, x * x)))
    return v / torch.clamp(n, min=1e-20)[:, None]


def build_world_geometry(pools, plan, node_tf, node_normal_tf, tri_flags,
                         dynamic_positions=None, dynamic_normals=None,
                         dynamic_tangents=None, device=None) -> WorldGeometry:
    """Gather + transform object pools into world-space pools and the packed
    f32 hit-attribute rows.

    Static scenes: host inputs in, numpy arrays out, unless `device` is
    given. With the dynamic pools of anim.skinning.DynamicMeshState
    (tensors, object space of their node), the skinned vertices source from
    them. With either, every field comes out as a tensor on `device` (by
    default the dynamic pools'); pools, plan and tri_flags may then already
    lie there (as tensors), which spares their upload each frame."""
    if device is None and dynamic_positions is not None:
        device = dynamic_positions.device
    dev = torch.device("cpu") if device is None else torch.device(device)

    def t(a):
        return torch.as_tensor(a, device=dev)

    vm = t(plan.vertex_map).long()
    vn = t(plan.vertex_node).long()
    pos = t(pools.positions)[vm]
    nrm = t(pools.normals)[vm]
    tan = t(pools.tangents)[vm]
    if dynamic_positions is not None:
        sk = (t(plan.vertex_skinned) != 0)[:, None]
        pos = torch.where(sk, dynamic_positions[vm], pos)
        nrm = torch.where(sk, dynamic_normals[vm], nrm)
        tan = torch.where(sk, dynamic_tangents[vm], tan)
    m = t(np.asarray(node_tf, np.float32))[vn]
    nm = t(np.asarray(node_normal_tf, np.float32))[vn]
    wpos = _matvec3(m[:, :3, :3], pos) + m[:, :3, 3]
    wnrm = _unit(_matvec3(nm[:, :3, :3], nrm))
    wtan = torch.cat([_unit(_matvec3(m[:, :3, :3], tan[:, :3])), tan[:, 3:4]], -1)
    uv0 = t(pools.uv0)[vm]
    uv1 = t(pools.uv1)[vm]
    color = t(pools.color)[vm]
    vertex_rows = torch.cat(
        [wpos, wnrm, wtan, uv0, uv1, color, torch.zeros((wpos.shape[0], 2), device=dev)], 1)
    tri_vertex = t(plan.tri_vertex).int()
    tri_material = t(plan.tri_material).int()
    flags = {k: t(v).int() for k, v in tri_flags.items()}
    flagbits = (
        flags["tri_has_ts"] * TRI_HAS_TS
        + flags["tri_has_uv0"] * TRI_HAS_UV0
        + flags["tri_has_uv1"] * TRI_HAS_UV1
        + flags["tri_has_color"] * TRI_HAS_COLOR
        + t(plan.tri_double_sided).int() * TRI_DOUBLE_SIDED
        + (t(plan.tri_alpha_mode).int() << TRI_ALPHA_SHIFT)
    ).int()
    nt = tri_vertex.shape[0]
    tv = tri_vertex.long()
    tri_rows = torch.cat([tri_vertex, tri_material[:, None], flagbits[:, None],
                          torch.zeros((nt, 3), dtype=torch.int32, device=dev)], 1)
    tri_attr_rows = torch.cat(
        [vertex_rows[tv[:, 0]], vertex_rows[tv[:, 1]], vertex_rows[tv[:, 2]],
         tri_material.view(torch.float32)[:, None], flagbits.view(torch.float32)[:, None],
         torch.zeros((nt, 2), device=dev)], 1)
    world = WorldGeometry(
        position=wpos, normal=wnrm, tangent=wtan, uv0=uv0, uv1=uv1, color=color,
        tri_vertex=t(plan.tri_vertex), tri_material=t(plan.tri_material),
        tri_double_sided=t(plan.tri_double_sided), tri_alpha_mode=t(plan.tri_alpha_mode),
        tri_has_ts=flags["tri_has_ts"], tri_has_uv0=flags["tri_has_uv0"],
        tri_has_uv1=flags["tri_has_uv1"], tri_has_color=flags["tri_has_color"],
        vertex_rows=vertex_rows, tri_rows=tri_rows, tri_attr_rows=tri_attr_rows,
    )
    if device is not None:
        return world
    return WorldGeometry(*[np.array(x.numpy()) for x in world])


def gather_lights(scene, node_tf: np.ndarray) -> T.GpuLights:
    """Per-frame light table (Renderer::GatherLights, Renderer.cpp:459-492)."""
    ln = scene.light_nodes
    lp = scene.light_params
    if len(ln) == 0:
        z3 = np.zeros((0, 3), np.float32)
        z = np.zeros(0, np.float32)
        return T.GpuLights(np.zeros(0, np.int32), z3, z3, z3, z, z, z, z)
    lid = np.asarray([scene.nodes[i].light for i in ln], np.int32)
    tf = node_tf[ln]
    pos = tf[:, :3, 3]
    ntf = np.transpose(np.linalg.inv(tf), (0, 2, 1))
    d = ntf[:, :3, :3] @ np.asarray([0.0, 0.0, -1.0], np.float32)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
    return T.GpuLights(
        type=lp.type[lid], position=pos.astype(np.float32), direction=d.astype(np.float32),
        color=lp.color[lid], intensity=lp.intensity[lid], cutoff=lp.cutoff[lid],
        inner_angle=lp.inner_angle[lid], outer_angle=lp.outer_angle[lid],
    )
