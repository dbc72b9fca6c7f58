"""The port's glTF loader (gltf_renderer_tpu_torch/scene/gltf.py) against the
JAX package's, and the port's writers against the in-memory scenes.

Tolerance: none. Both loaders are host numpy doing the same operations, so
every table, node, skin, animation, camera and iridescence entry must hold
the same values with the same dtype and shape, bit for bit (float arrays
compared as bytes, so NaN-bitcast ints in the material rows compare too).
Each writer of gltf_renderer_tpu/scene/procedural.py is one case, plus
hand-built documents: a sparse accessor, KHR_texture_transform, dispersion
(as tests/test_loader.py builds them), an external .bin buffer, a node
matrix with a mirror, and a document using every supported extension,
sampler mode, primitive mode and interpolation the loader reads.
"""

import base64
import dataclasses
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from gltf_renderer_tpu.scene import procedural as jproc
from gltf_renderer_tpu.scene.gltf import load_gltf as jax_load_gltf
from gltf_renderer_tpu_torch.convert import from_jax_scene
from gltf_renderer_tpu_torch.scene import procedural as pproc
from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.scene.gltf import load_gltf


def _same(port, ref, where="scene"):
    """Assert `port` (the port's object) holds what `ref` (the JAX
    package's) holds: arrays by dtype, shape and bytes; NamedTuples and
    dataclasses field by field over the port's fields; lists elementwise."""
    if isinstance(port, np.ndarray) or isinstance(ref, np.ndarray):
        a, b = np.asarray(port), np.asarray(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape,
                                                            b.shape)
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(port, tuple) and hasattr(port, "_fields"):
        for f in port._fields:
            _same(getattr(port, f), getattr(ref, f), f"{where}.{f}")
    elif dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _same(getattr(port, f.name), getattr(ref, f.name), f"{where}.{f.name}")
    elif isinstance(port, list):
        assert isinstance(ref, list) and len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, f"{where}[{i}]")
    else:
        assert port == ref and type(port) is type(ref), (where, port, ref)


def _png_uri(img):
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _sparse(path):
    base = np.zeros((6, 3), np.float32).tobytes()
    blob = (base + np.asarray([1, 3], np.uint16).tobytes()
            + np.asarray([[1, 2, 3], [4, 5, 6]], np.float32).tobytes())
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 72},
                        {"buffer": 0, "byteOffset": 72, "byteLength": 4},
                        {"buffer": 0, "byteOffset": 76, "byteLength": 24}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 6, "type": "VEC3",
                       "sparse": {"count": 2,
                                  "indices": {"bufferView": 1, "componentType": 5123},
                                  "values": {"bufferView": 2}}}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}],
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _texture_transform(path):
    jproc.write_box_gltf(path)
    doc = json.load(open(path))
    doc["images"] = [{"uri": _png_uri(np.full((4, 4, 4), 128, np.uint8))}]
    doc["textures"] = [{"source": 0}]
    doc.setdefault("extensionsUsed", []).append("KHR_texture_transform")
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
        "index": 0, "extensions": {"KHR_texture_transform": {
            "offset": [0.25, 0.5], "scale": [2.0, 3.0], "rotation": 0.7}}}
    json.dump(doc, open(path, "w"))
    return path


def _dispersion(path):
    jproc.write_box_gltf(path)
    doc = json.load(open(path))
    doc.setdefault("extensionsUsed", []).append("KHR_materials_dispersion")
    doc["materials"][0].setdefault("extensions", {})["KHR_materials_dispersion"] = {
        "dispersion": 0.13}
    json.dump(doc, open(path, "w"))
    return path


def _external_bin(path):
    """The box with its buffer in a file beside the document, named with a
    space that the URI spells %20."""
    jproc.write_box_gltf(path)
    doc = json.load(open(path))
    uri = doc["buffers"][0]["uri"]
    with open(os.path.join(os.path.dirname(path), "box data.bin"), "wb") as f:
        f.write(base64.b64decode(uri[uri.index(",") + 1:]))
    doc["buffers"][0]["uri"] = "box%20data.bin"
    json.dump(doc, open(path, "w"))
    return path


def _matrix_nodes(path):
    """Node transforms given as column-major matrices: a rotation with
    scale, and a mirrored (negative determinant) one."""
    jproc.write_box_gltf(path, double_box=True)
    doc = json.load(open(path))
    c, s = np.cos(0.6), np.sin(0.6)
    m = np.asarray([[c * 2, 0, s * 2, 0], [0, 1.5, 0, 0], [-s, 0, c, 0], [0.3, -0.2, 1.0, 1]])
    doc["nodes"][0]["matrix"] = m.reshape(-1).tolist()
    mirror = np.diag([-1.0, 1.0, 1.0, 1.0])
    mirror[3, :3] = [1.5, 0.0, 0.5]
    doc["nodes"][1].pop("translation")
    doc["nodes"][1]["matrix"] = mirror.reshape(-1).tolist()
    json.dump(doc, open(path, "w"))
    return path


def _kitchen_sink(path):
    """Every extension the loader reads, with textures on every slot it
    fills; samplers with nearest filtering, clamp and mirror wraps; a
    triangle strip, a skipped point primitive, RGB vertex colours,
    normalized u8 joints weights, tangents, TEXCOORD_1, two morph targets
    with normals and tangents; STEP, CUBICSPLINE and multi-target weight
    channels; an orthographic camera; spot and directional lights."""
    doc = {"asset": {"version": "2.0"}, "scene": 0, "extensionsUsed": sorted(
        ["KHR_texture_transform", "KHR_materials_anisotropy", "KHR_materials_clearcoat",
         "KHR_materials_dispersion", "KHR_materials_emissive_strength", "KHR_materials_ior",
         "KHR_materials_iridescence", "KHR_materials_sheen", "KHR_materials_specular",
         "KHR_materials_transmission", "KHR_materials_volume", "KHR_materials_unlit",
         "KHR_lights_punctual"])}
    bin_parts = []
    rs = np.random.RandomState(5)
    p, n, uv, idx = jproc.box_mesh()
    nv = len(p)
    tan = np.concatenate([np.roll(n, 1, 1), np.where(rs.rand(nv, 1) < 0.5, 1.0, -1.0)],
                         1).astype(np.float32)
    acc = {k: jproc._acc(doc, bin_parts, v, target=34962) for k, v in {
        "POSITION": p, "NORMAL": n, "TANGENT": tan, "TEXCOORD_0": uv,
        "TEXCOORD_1": (uv * 0.5).astype(np.float32),
        "COLOR_0": rs.rand(nv, 3).astype(np.float32)}.items()}
    acc["JOINTS_0"] = jproc._acc(doc, bin_parts, rs.randint(0, 2, (nv, 4)).astype(np.uint8))
    acc["WEIGHTS_0"] = jproc._acc(doc, bin_parts, rs.randint(0, 256, (nv, 4)).astype(np.uint8),
                                  normalized=True)
    ii = jproc._acc(doc, bin_parts, idx, target=34963)
    strip = jproc._acc(doc, bin_parts, np.asarray([0, 1, 3, 2, 6, 7], np.uint16))
    targets = [{k: jproc._acc(doc, bin_parts, (rs.rand(nv, 3) * 0.1).astype(np.float32))
                for k in ("POSITION", "NORMAL", "TANGENT")} for _ in range(2)]
    doc["meshes"] = [{"primitives": [
        {"attributes": acc, "indices": ii, "material": 0, "targets": targets},
        {"attributes": {"POSITION": acc["POSITION"], "NORMAL": acc["NORMAL"]},
         "indices": strip, "mode": 5, "material": 1},
        {"attributes": {"POSITION": acc["POSITION"]}, "mode": 0},
    ], "weights": [0.3, 0.6]}]
    imgs = [rs.randint(0, 256, (8 + 4 * i, 8, 4)).astype(np.uint8) for i in range(3)]
    doc["images"] = [{"uri": _png_uri(im)} for im in imgs]
    doc["samplers"] = [{"magFilter": 9728, "wrapS": 33071, "wrapT": 33648},
                       {"wrapS": 33648, "wrapT": 10497}]
    doc["textures"] = [{"source": 0, "sampler": 0}, {"source": 1, "sampler": 1},
                       {"source": 2}]

    def tex(i, **kw):
        return {"index": i, **kw}

    xf = {"extensions": {"KHR_texture_transform": {"offset": [0.1, 0.2], "rotation": 0.3,
                                                   "scale": [1.5, 0.5], "texCoord": 1}}}
    doc["materials"] = [
        {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.8, 0.7, 0.6],
                                  "baseColorTexture": tex(0, **xf),
                                  "metallicRoughnessTexture": tex(1, texCoord=1),
                                  "metallicFactor": 0.2, "roughnessFactor": 0.7},
         "normalTexture": tex(2, scale=0.5), "occlusionTexture": tex(1, strength=0.4),
         "emissiveTexture": tex(0), "emissiveFactor": [0.5, 0.25, 0.125],
         "alphaMode": "BLEND", "doubleSided": True,
         "extensions": {
             "KHR_materials_emissive_strength": {"emissiveStrength": 3.0},
             "KHR_materials_ior": {"ior": 1.33},
             "KHR_materials_anisotropy": {"anisotropyStrength": 0.4,
                                          "anisotropyRotation": 0.2,
                                          "anisotropyTexture": tex(2)},
             "KHR_materials_clearcoat": {"clearcoatFactor": 0.9,
                                         "clearcoatRoughnessFactor": 0.1,
                                         "clearcoatTexture": tex(0),
                                         "clearcoatRoughnessTexture": tex(1),
                                         "clearcoatNormalTexture": tex(2, scale=0.8)},
             "KHR_materials_sheen": {"sheenColorFactor": [0.2, 0.3, 0.4],
                                     "sheenRoughnessFactor": 0.5,
                                     "sheenColorTexture": tex(0),
                                     "sheenRoughnessTexture": tex(1)},
             "KHR_materials_specular": {"specularFactor": 0.6,
                                        "specularColorFactor": [0.9, 1.0, 0.8],
                                        "specularTexture": tex(2),
                                        "specularColorTexture": tex(0)},
             "KHR_materials_transmission": {"transmissionFactor": 0.7,
                                            "transmissionTexture": tex(1)},
             "KHR_materials_volume": {"thicknessFactor": 0.2, "attenuationDistance": 1.5,
                                      "attenuationColor": [0.9, 0.5, 0.4],
                                      "thicknessTexture": tex(2)},
             "KHR_materials_dispersion": {"dispersion": 0.05},
             "KHR_materials_iridescence": {"iridescenceFactor": 0.7, "iridescenceIor": 1.8,
                                           "iridescenceThicknessMinimum": 50.0},
         }},
        {"alphaMode": "MASK", "alphaCutoff": 0.3,
         "extensions": {"KHR_materials_unlit": {}}},
    ]
    times = jproc._acc(doc, bin_parts, np.asarray([0.0, 0.5, 1.5], np.float32))
    cubic = jproc._acc(doc, bin_parts, rs.rand(9, 3).astype(np.float32))
    cubic_rot = jproc._acc(doc, bin_parts, rs.rand(9, 4).astype(np.float32))
    step = jproc._acc(doc, bin_parts, rs.rand(3, 3).astype(np.float32))
    weights = jproc._acc(doc, bin_parts, rs.rand(6).astype(np.float32))
    doc["animations"] = [{"name": "all", "samplers": [
        {"input": times, "output": cubic, "interpolation": "CUBICSPLINE"},
        {"input": times, "output": step, "interpolation": "STEP"},
        {"input": times, "output": weights},
        {"input": times, "output": cubic_rot, "interpolation": "CUBICSPLINE"},
    ], "channels": [
        {"sampler": 0, "target": {"node": 0, "path": "translation"}},
        {"sampler": 1, "target": {"node": 1, "path": "scale"}},
        {"sampler": 2, "target": {"node": 0, "path": "weights"}},
        {"sampler": 3, "target": {"node": 1, "path": "rotation"}},
        {"sampler": 1, "target": {"path": "scale"}},
    ]}, {"channels": [], "samplers": []}]
    doc["skins"] = [{"joints": [1, 2], "skeleton": 1}]
    doc["cameras"] = [{"type": "orthographic",
                       "orthographic": {"xmag": 2.0, "ymag": 1.5, "znear": 0.2, "zfar": 50.0}},
                      {"type": "perspective", "perspective": {"yfov": 0.9, "aspectRatio": 1.2,
                                                              "znear": 0.05, "zfar": 90.0}}]
    doc["extensions"] = {"KHR_lights_punctual": {"lights": [
        {"type": "spot", "color": [1, 0.5, 0.2], "intensity": 5.0, "range": 9.0,
         "spot": {"innerConeAngle": 0.2, "outerConeAngle": 0.6}},
        {"type": "directional", "intensity": 2.0}]}}
    doc["nodes"] = [
        {"mesh": 0, "skin": 0, "children": [3], "weights": [0.1, 0.9], "name": "sink"},
        {"children": [2], "rotation": [0, 0.6, 0, 0.8], "camera": 0},
        {"translation": [0, 1, 0], "scale": [1, 2, 1], "camera": 1},
        {"extensions": {"KHR_lights_punctual": {"light": 0}}, "translation": [1, 2, 3]},
        {"extensions": {"KHR_lights_punctual": {"light": 1}}},
    ]
    doc["scenes"] = [{"nodes": [0, 1]}, {"nodes": [4]}]
    doc["scene"] = 1
    return _write(path, doc, bin_parts)


def _write(path, doc, bin_parts):
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": jproc._buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


WRITERS = {
    "box": lambda d: jproc.write_box_gltf(os.path.join(d, "box.gltf")),
    "double_box": lambda d: jproc.write_box_gltf(os.path.join(d, "b2.gltf"), double_box=True,
                                                 with_light=False),
    "textured_sphere": lambda d: jproc.write_textured_sphere_glb(os.path.join(d, "s.glb")),
    "skinned": lambda d: jproc.write_skinned_gltf(os.path.join(d, "skin.gltf")),
    "skinned_strips": lambda d: jproc.write_skinned_gltf(os.path.join(d, "sk3.gltf"), strips=3),
    "box_official": lambda d: jproc.write_box_official_layout_gltf(os.path.join(d, "bo.gltf")),
    "morph_cube_official": lambda d: jproc.write_morph_cube_official_layout_gltf(
        os.path.join(d, "mo.gltf")),
    "multiuv": lambda d: jproc.write_multiuv_gltf(os.path.join(d, "uv.gltf")),
    "camera_anim": lambda d: jproc.write_camera_anim_gltf(os.path.join(d, "cam.gltf")),
    "morph": lambda d: jproc.write_morph_gltf(os.path.join(d, "morph.gltf")),
    "materials": lambda d: jproc.write_materials_gltf(os.path.join(d, "zoo.gltf")),
    "foliage": lambda d: jproc.write_foliage_gltf(os.path.join(d, "leaf.gltf")),
    "plane_directional": lambda d: jproc.write_plane_light_gltf(os.path.join(d, "pd.gltf")),
    "plane_point": lambda d: jproc.write_plane_light_gltf(os.path.join(d, "pp.gltf"),
                                                          kind="point"),
    "courtyard": lambda d: jproc.write_courtyard_glb(os.path.join(d, "court.glb"),
                                                     tex_size=32),
    "sparse": lambda d: _sparse(os.path.join(d, "sparse.gltf")),
    "texture_transform": lambda d: _texture_transform(os.path.join(d, "tt.gltf")),
    "dispersion": lambda d: _dispersion(os.path.join(d, "disp.gltf")),
    "external_bin": lambda d: _external_bin(os.path.join(d, "ext.gltf")),
    "matrix_nodes": lambda d: _matrix_nodes(os.path.join(d, "mat.gltf")),
    "kitchen_sink": lambda d: _kitchen_sink(os.path.join(d, "sink.gltf")),
}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_loader_matches_jax(name, tmp_path):
    path = WRITERS[name](str(tmp_path))
    port = load_gltf(path)
    _same(port, jax_load_gltf(path))
    assert isinstance(port, T.Scene) and port.name == os.path.basename(path)


def test_kitchen_sink_reads_every_branch(tmp_path):
    """The hand-built document really reaches the branches it is for."""
    s = load_gltf(_kitchen_sink(str(tmp_path / "sink.gltf")))
    m = s.materials
    assert (m.tex_index[1] >= 0).all() and m.flags[2] & T.MATERIAL_FLAG_UNLIT
    assert m.alpha_mode[1:].tolist() == [T.ALPHA_MODE_BLEND, T.ALPHA_MODE_MASK]
    assert set(s.textures.nearest.tolist()) == {0, 1}
    assert {T.WRAP_CLAMP, T.WRAP_MIRROR, T.WRAP_REPEAT} <= set(s.textures.wrap_s.tolist()
                                                              + s.textures.wrap_t.tolist())
    assert len(s.primitives.tri_count) == 2 and s.primitives.morph_count.tolist() == [2, 0]
    interps = {c.interpolation for c in s.animations[0].channels}
    assert interps == {T.INTERP_STEP, T.INTERP_LINEAR, T.INTERP_CUBICSPLINE}
    assert len(s.animations[0].channels) == 4 and s.animations[1].duration == 0.0
    assert s.cameras[0].type == "orthographic" and s.iridescence[1].factor == 0.7
    assert s.light_nodes.tolist() == [3, 4] and s.default_scene == 1


def test_unsupported_required_extension_is_refused(tmp_path):
    path = jproc.write_box_gltf(str(tmp_path / "box.gltf"))
    doc = json.load(open(path))
    doc["extensionsRequired"] = ["KHR_draco_mesh_compression"]
    json.dump(doc, open(path, "w"))
    for loader in (load_gltf, jax_load_gltf):
        with pytest.raises(ValueError, match="unsupported required extension"):
            loader(path)


def test_from_jax_scene_is_the_ports_read(tmp_path):
    """convert.from_jax_scene gives the port's types holding the JAX read."""
    path = _kitchen_sink(str(tmp_path / "sink.gltf"))
    conv = from_jax_scene(jax_load_gltf(path))
    port = load_gltf(path)
    _same(conv, port)
    assert type(conv.materials) is T.MaterialTable and type(conv.skins[0]) is T.Skin


PORT_WRITERS = {  # kind: (writer name, file extension, keywords)
    "courtyard": ("write_courtyard_glb", ".glb", dict(tex_size=32)),
    "skinned": ("write_skinned_gltf", ".gltf", dict(strips=3)),
    "morph": ("write_morph_gltf", ".gltf", {}),
    "box": ("write_box_gltf", ".gltf", {}),
    "double_box_unlit": ("write_box_gltf", ".gltf", dict(double_box=True, with_light=False,
                                                         base_color=(0.1, 0.9, 0.1, 1.0))),
    "textured_sphere": ("write_textured_sphere_glb", ".glb", dict(metallic=0.4,
                                                                  roughness=0.35)),
    "materials": ("write_materials_gltf", ".gltf", {}),
}


@pytest.mark.parametrize("kind", list(PORT_WRITERS))
def test_port_writers_match_jax_writers(kind, tmp_path):
    """The port's writers write what the JAX package's write, byte for
    byte, and as the loader reads it."""
    name, ext, kw = PORT_WRITERS[kind]
    a = getattr(pproc, name)(os.path.join(str(tmp_path), "p" + ext), **kw)
    b = getattr(jproc, name)(os.path.join(str(tmp_path), "j" + ext), **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    _same(dataclasses.replace(load_gltf(a), name=""), dataclasses.replace(load_gltf(b), name=""))


def test_courtyard_glb_is_the_in_memory_courtyard(tmp_path):
    """The loader's read of the port's courtyard GLB is procedural.courtyard_scene,
    table for table, and its nodes (the file adds the camera and a name)."""
    s = load_gltf(pproc.write_courtyard_glb(str(tmp_path / "c.glb"), tex_size=32))
    ref = pproc.courtyard_scene(tex_size=32)
    for field in ("pools", "primitives", "materials", "textures", "light_params",
                  "light_nodes", "nodes", "scenes", "meshes", "topo_order"):
        _same(getattr(s, field), getattr(ref, field), field)
    assert len(s.cameras) == 1 and s.pools.tri_vertex.shape[0] == 273856


def test_quantize_tangent_space_is_the_jax_loaders():
    from gltf_renderer_tpu.scene.gltf import quantize_tangent_space as jax_q
    from gltf_renderer_tpu_torch.scene.gltf import quantize_tangent_space

    rs = np.random.RandomState(3)
    n = rs.normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t = np.concatenate([rs.normal(size=(500, 3)), np.sign(rs.normal(size=(500, 1)))], 1)
    for tan in (None, t.astype(np.float32)):
        for a, b in zip(quantize_tangent_space(n, tan), jax_q(n, tan)):
            _same(a, b)
