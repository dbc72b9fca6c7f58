"""State carried across from the JAX package: its Scene and PTScene -> the
port's.

`from_jax_scene` takes a host Scene of the JAX package's loader (numpy
leaves) and returns the port's `scene.types.Scene` with the same values, so
both packages can start from identical inputs.

`from_jax_pt_scene` takes a JAX `PTScene` whose leaves were pulled to numpy
(`jax.tree.map(np.asarray, scene)`) and its `PTMeta`, and returns the
port's `PTScene` / `PTMeta` on `device`, so both packages can run on
identical tables: geometry, BVH, materials, the linear atlas and its mip
pyramid, the environment (cube level 0, importance, alias rows and the
GGX / diffuse prefilters) and the Sheen_E LUT. It reads fields by name and imports nothing of
JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gltf_renderer_tpu_torch.device import resolve
from gltf_renderer_tpu_torch.env.environment import EnvMaps
from gltf_renderer_tpu_torch.ops import bvh as bvh_ops
from gltf_renderer_tpu_torch.render.pathtracer import PTMeta, PTScene
from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.scene.flatten import WorldGeometry


def _tensor(x, dev):
    return None if x is None else torch.as_tensor(np.array(x), device=dev)


def _fields(cls, src, convert=lambda v: v):
    return cls(**{f: convert(getattr(src, f)) for f in cls._fields if hasattr(src, f)})


def _dataclass(cls, src):
    return cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})


def from_jax_scene(scene) -> T.Scene:
    """JAX host Scene (numpy leaves) -> the port's Scene, field by field."""
    tables = {f: _fields(getattr(T, type(getattr(scene, f)).__name__), getattr(scene, f))
              for f in ("pools", "primitives", "materials", "textures", "light_params")}
    return T.Scene(
        **tables,
        light_nodes=scene.light_nodes,
        nodes=[_dataclass(T.Node, n) for n in scene.nodes],
        scenes=[list(s) for s in scene.scenes],
        default_scene=scene.default_scene,
        meshes=[_dataclass(T.MeshDef, m) for m in scene.meshes],
        skins=[_dataclass(T.Skin, s) for s in scene.skins],
        animations=[T.Animation(name=a.name,
                                channels=[_dataclass(T.AnimationChannel, c) for c in a.channels])
                    for a in scene.animations],
        cameras=[_dataclass(T.CameraDef, c) for c in scene.cameras],
        iridescence=[_dataclass(T.IridescenceParams, i) for i in scene.iridescence],
        topo_order=scene.topo_order,
        name=scene.name,
    )


def from_jax_pt_scene(scene_np, meta, device="cuda"):
    """(JAX PTScene with numpy leaves, JAX PTMeta) -> (PTScene, PTMeta)."""
    dev = resolve(device)
    maps = scene_np.wide_maps
    wide_meta = np.asarray(maps.meta)
    env = scene_np.env
    port_env = None
    if env is not None:
        port_env = EnvMaps(
            cube=[_tensor(env.cube[0], dev)],
            importance=[_tensor(m, dev) for m in env.importance],
            equirect=_tensor(env.equirect, dev),
            alias_rows=_tensor(env.alias_rows, dev),
            ggx=[_tensor(m, dev) for m in (env.ggx or [])],
            diffuse=_tensor(env.diffuse, dev),
        )
    materials = _fields(T.MaterialTable, scene_np.materials)
    textures = _fields(T.TextureTable, scene_np.textures)
    scene = PTScene(
        world=_fields(WorldGeometry, scene_np.world, lambda v: _tensor(v, dev)),
        bvh=_fields(bvh_ops.FlatBVH, scene_np.bvh, np.asarray),
        packed=bvh_ops.PackedBVH(
            nodes=np.asarray(scene_np.packed.nodes), records=np.asarray(scene_np.packed.records),
            words=np.asarray(scene_np.packed.words), n_nodes=int(scene_np.packed.n_nodes)),
        materials=materials._replace(rows=_tensor(materials.rows, dev)),
        textures=textures._replace(rows=_tensor(textures.rows, dev),
                                   atlas_linear=_tensor(textures.atlas_linear, dev),
                                   mip_flat=_tensor(textures.mip_flat, dev),
                                   mip_rows=_tensor(textures.mip_rows, dev)),
        lights=_fields(T.GpuLights, scene_np.lights, lambda v: _tensor(v, dev)),
        env=port_env,
        sheen_table=_tensor(scene_np.sheen_table, dev),
        wide_nodes=_tensor(scene_np.wide_nodes, dev),
        wide_maps=bvh_ops.WideMaps(child_src=np.asarray(maps.child_src),
                                   meta=_tensor(wide_meta, dev),
                                   leaf_ids=np.asarray(maps.leaf_ids)),
        leaf_records=_tensor(scene_np.leaf_records, dev),
        leaf_words=_tensor(scene_np.leaf_words, dev),
    )
    port_meta = PTMeta(**meta._asdict(),
                       stack_bound=bvh_ops.wide_stack_bound(wide_meta, meta.wide_root))
    return scene, port_meta
