"""Scene data model (host side, numpy).

Mirrors gltf_renderer_tpu/scene/types.py field for field: the port's glTF
loader (scene/gltf.py) fills these types, and a scene loaded by the JAX
package's loader converts into them (`convert.from_jax_scene`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import numpy as np

# Texture slots — order mirrors Material.hlsli:35-65.
TEX_NORMAL = 0
TEX_ALBEDO = 1
TEX_METALLIC_ROUGHNESS = 2
TEX_OCCLUSION = 3
TEX_EMISSIVE = 4
TEX_SPECULAR = 5
TEX_SPECULAR_COLOR = 6
TEX_CLEARCOAT = 7
TEX_CLEARCOAT_ROUGHNESS = 8
TEX_CLEARCOAT_NORMAL = 9
TEX_ANISOTROPY = 10
TEX_SHEEN_COLOR = 11
TEX_SHEEN_ROUGHNESS = 12
TEX_TRANSMISSION = 13
TEX_THICKNESS = 14
N_TEX_SLOTS = 15

MATERIAL_FLAG_DOUBLE_SIDED = 1 << 0
MATERIAL_FLAG_UNLIT = 1 << 1

ALPHA_MODE_OPAQUE = 0
ALPHA_MODE_MASK = 1
ALPHA_MODE_BLEND = 2

LIGHT_TYPE_POINT = 0
LIGHT_TYPE_SPOT = 1
LIGHT_TYPE_DIRECTIONAL = 2

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2

# Animation paths / interpolation.
PATH_TRANSLATION = 0
PATH_ROTATION = 1
PATH_SCALE = 2
PATH_WEIGHTS = 3
INTERP_STEP = 0
INTERP_LINEAR = 1
INTERP_CUBICSPLINE = 2

# Packed material row layout (see pack_material_rows).
MATERIAL_ROW_FACTORS = 34
MATERIAL_SLOT_STRIDE = 7


class MaterialTable(NamedTuple):
    """SoA material table; row 0 is the default material."""

    flags: Any
    alpha_mode: Any
    base_color_factor: Any
    metalness_factor: Any
    roughness_factor: Any
    occlusion_factor: Any
    emissive_factor: Any
    alpha_cutoff: Any
    ior: Any
    normal_scale: Any
    specular_factor: Any
    specular_color_factor: Any
    clearcoat_factor: Any
    clearcoat_roughness_factor: Any
    clearcoat_normal_scale: Any
    anisotropy_strength: Any
    anisotropy_rotation: Any
    sheen_color_factor: Any
    sheen_roughness_factor: Any
    transmission_factor: Any
    thickness_factor: Any
    attenuation_distance: Any
    attenuation_color: Any
    dispersion: Any
    tex_index: Any
    tex_uvset: Any
    tex_rotation: Any
    tex_offset: Any
    tex_scale: Any
    rows: Any = None


class TextureTable(NamedTuple):
    """One u8 RGBA atlas + per-texture addressing metadata."""

    atlas: Any      # (AH, AW, 4) uint8
    x: Any
    y: Any
    width: Any
    height: Any
    wrap_s: Any
    wrap_t: Any
    nearest: Any
    srgb: Any
    rows: Any = None          # (T, 9) f32 [x, y, w, h, wrap_s, wrap_t, nearest, srgb, pad]
    atlas_linear: Any = None  # (AH*AW, 4) f16, pre-decoded to linear
    mip_flat: Any = None      # (M, 4) f16 every texture's mip chain (build_atlas_mips)
    mip_rows: Any = None      # (T * MAXL, 4) f32 [base (bitcast i32), w, h, 0]


class GeometryPools(NamedTuple):
    positions: Any
    normals: Any
    tangents: Any
    uv0: Any
    uv1: Any
    color: Any
    joints: Any
    weights: Any
    tri_vertex: Any
    tri_prim: Any
    morph_pos: Any
    morph_normal: Any
    morph_tangent: Any


class PrimitiveTable(NamedTuple):
    vertex_offset: Any
    vertex_count: Any
    tri_offset: Any
    tri_count: Any
    material: Any
    has_tangent_space: Any
    has_uv0: Any
    has_uv1: Any
    has_color: Any
    has_joints: Any
    morph_offset: Any
    morph_count: Any


class LightParams(NamedTuple):
    type: Any
    color: Any
    intensity: Any
    cutoff: Any
    inner_angle: Any
    outer_angle: Any


class GpuLights(NamedTuple):
    type: Any
    position: Any
    direction: Any
    color: Any
    intensity: Any
    cutoff: Any
    inner_angle: Any
    outer_angle: Any


class InstancePlan(NamedTuple):
    vertex_map: Any
    vertex_node: Any
    vertex_skinned: Any
    tri_vertex: Any
    tri_material: Any
    tri_prim: Any
    tri_double_sided: Any
    tri_alpha_mode: Any
    instance_node: Any
    instance_prim: Any


@dataclasses.dataclass
class Node:
    name: str = ""
    parent: int = -1
    children: List[int] = dataclasses.field(default_factory=list)
    translation: np.ndarray = None
    rotation: np.ndarray = None
    scale: np.ndarray = None
    mesh: int = -1
    skin: int = -1
    camera: int = -1
    light: int = -1
    weights: Optional[np.ndarray] = None


@dataclasses.dataclass
class Skin:
    joints: np.ndarray            # (J,) node ids
    inverse_bind: np.ndarray      # (J, 4, 4) row-major
    skeleton: int = -1


@dataclasses.dataclass
class AnimationChannel:
    node: int
    path: int            # PATH_*
    interpolation: int   # INTERP_*
    times: np.ndarray    # (K,)
    values: np.ndarray   # (K, D), or (3K, D) for a cubic spline


@dataclasses.dataclass
class Animation:
    name: str
    channels: List[AnimationChannel]

    @property
    def duration(self) -> float:
        return max((float(c.times[-1]) for c in self.channels if len(c.times)), default=0.0)


@dataclasses.dataclass
class IridescenceParams:
    """KHR_materials_iridescence, parsed but read by neither backend."""

    factor: float = 0.0
    ior: float = 1.3
    thickness_minimum: float = 100.0
    thickness_maximum: float = 400.0


@dataclasses.dataclass
class CameraDef:
    type: str = "perspective"   # or "orthographic"
    yfov: float = 1.0
    aspect: float = 0.0         # 0 = use the viewport's
    znear: float = 0.1
    zfar: float = 0.0           # 0 = infinite
    xmag: float = 1.0
    ymag: float = 1.0


@dataclasses.dataclass
class MeshDef:
    primitives: List[int]
    weights: Optional[np.ndarray] = None


@dataclasses.dataclass
class Scene:
    """Host scene as the glTF loader returns it."""

    pools: GeometryPools
    primitives: PrimitiveTable
    materials: MaterialTable
    textures: TextureTable
    light_params: LightParams
    light_nodes: np.ndarray
    nodes: List[Node] = dataclasses.field(default_factory=list)
    scenes: List[List[int]] = dataclasses.field(default_factory=list)
    default_scene: int = 0
    meshes: List[MeshDef] = dataclasses.field(default_factory=list)
    skins: List[Skin] = dataclasses.field(default_factory=list)
    animations: List[Animation] = dataclasses.field(default_factory=list)
    cameras: List[CameraDef] = dataclasses.field(default_factory=list)
    iridescence: List[IridescenceParams] = dataclasses.field(default_factory=list)
    topo_order: np.ndarray = None
    name: str = ""

    def num_nodes(self) -> int:
        return len(self.nodes)


def pack_material_rows(m) -> np.ndarray:
    """Pack a MaterialTable into (M, 144) f32 rows (ints bitcast); layout as
    gltf_renderer_tpu.scene.types.pack_material_rows."""
    n = len(np.asarray(m.flags))
    rows = np.zeros((n, 144), np.float32)
    rows[:, 0:4] = m.base_color_factor
    rows[:, 4] = m.metalness_factor
    rows[:, 5] = m.roughness_factor
    rows[:, 6] = m.occlusion_factor
    rows[:, 7:10] = m.emissive_factor
    rows[:, 10] = m.alpha_cutoff
    rows[:, 11] = m.ior
    rows[:, 12] = m.normal_scale
    rows[:, 13] = m.specular_factor
    rows[:, 14:17] = m.specular_color_factor
    rows[:, 17] = m.clearcoat_factor
    rows[:, 18] = m.clearcoat_roughness_factor
    rows[:, 19] = m.clearcoat_normal_scale
    rows[:, 20] = m.anisotropy_strength
    rows[:, 21] = m.anisotropy_rotation
    rows[:, 22:25] = m.sheen_color_factor
    rows[:, 25] = m.sheen_roughness_factor
    rows[:, 26] = m.transmission_factor
    rows[:, 27] = m.thickness_factor
    rows[:, 28] = m.attenuation_distance
    rows[:, 29:32] = m.attenuation_color
    rows[:, 32] = np.asarray(m.flags, np.int32).view(np.float32)
    rows[:, 33] = np.asarray(m.alpha_mode, np.int32).view(np.float32)
    for s in range(N_TEX_SLOTS):
        b = MATERIAL_ROW_FACTORS + MATERIAL_SLOT_STRIDE * s
        rows[:, b] = np.asarray(m.tex_index[:, s], np.int32).view(np.float32)
        rows[:, b + 1] = np.asarray(m.tex_uvset[:, s], np.int32).view(np.float32)
        rows[:, b + 2] = m.tex_rotation[:, s]
        rows[:, b + 3 : b + 5] = m.tex_offset[:, s]
        rows[:, b + 5 : b + 7] = m.tex_scale[:, s]
    return rows


def pack_texture_rows(t) -> np.ndarray:
    n = len(np.asarray(t.x))
    rows = np.zeros((n, 9), np.float32)
    if n:
        rows[:, 0] = t.x
        rows[:, 1] = t.y
        rows[:, 2] = t.width
        rows[:, 3] = t.height
        rows[:, 4] = t.wrap_s
        rows[:, 5] = t.wrap_t
        rows[:, 6] = t.nearest
        rows[:, 7] = t.srgb
    return rows
