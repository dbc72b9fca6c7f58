"""What a configuration may bring as files: its own reference package, glTF
extensions in its scene dict, and metrics that read the program's
per-frame counters; and that the two configurations the benchmark has
are unchanged by it."""

from __future__ import annotations

import ast
import functools
import hashlib
import json
import os
import shutil

import numpy as np
import pytest

from perfbench import harness, spec
from perfbench.glb import write_glb
from perfbench.reference import pathtracer as ref_pt
from perfbench.reference import render as ref_render
from perfbench.scenes import courtyard, textured_sphere
from perfbench.tests.tiny import TINY_SCENES, cpu_environment, tiny_cell

HERE = os.path.join(spec.ROOT, "perfbench")
JAX_NAMES = {"jax", "jaxlib", "flax", "gltf_renderer_tpu"}
PROGRAM = "gltf_renderer_tpu_torch"

# sha256 of the GLBs that the writer of commit b2df843 (before glTF
# extensions passed through it) wrote at TINY_SCENES' sizes; the PNGs in
# them are zlib level 1 (zlib 1.2.13 when pinned).
PARENT_GLB_SHA256 = {
    "courtyard": "0cc64ff82da3befd78aafc3a32ee82f1202553c93d6d46d8f53b9f11048e302f",
    "textured_sphere": "ec4115bc1944f0b0c50a01a6c0bbfa62fd91f20f1b46aab44fed7dcd728a2f86",
}


@pytest.mark.parametrize("workload", ["courtyard.pt_still", "helmet.pt_still"])
def test_cells_resolve_to_the_default_reference(workload):
    cell = spec.load_cell(workload)
    assert cell.reference == "reference" and "reference" not in cell.config
    assert spec.reference(cell.reference, cell.here) is ref_render
    # The settings the harness built itself before references were named.
    assert ref_render.settings(cell.config["pt"]) == ref_pt.Settings(
        max_bounces=2, min_bounces=2, luminance_clamp=True)


def test_a_reference_of_another_name_is_refused(tmp_path):
    pb = tmp_path / "perfbench"
    for d in ("configs", "traffic", "limits"):
        (pb / d).mkdir(parents=True)
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(HERE, "configs", "helmet.json")))
    (pb / "configs" / "helmet.json").write_text(json.dumps(dict(cfg, reference="reference_ball")))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="reference_helmet"):
        spec.load_cell("helmet.pt_still", str(tmp_path))


@pytest.mark.parametrize("generator", sorted(PARENT_GLB_SHA256))
def test_glb_of_each_configuration_is_the_parents(tmp_path, generator):
    mod = {"courtyard": courtyard, "textured_sphere": textured_sphere}[generator]
    path = write_glb(str(tmp_path / "s.glb"), mod.build(**TINY_SCENES[generator]))
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == PARENT_GLB_SHA256[generator]


def _light(light):
    return {"KHR_lights_punctual": {"lights": [light]}}


EXTENSIONS = {
    "clearcoat": (
        {"KHR_materials_clearcoat": {"clearcoatFactor": 0.8, "clearcoatRoughnessFactor": 0.15,
                                     "clearcoatTexture": {"index": 2}}},
        None,
        {"clearcoat_factor": 0.8, "clearcoat_roughness_factor": 0.15}),
    "sheen": (
        {"KHR_materials_sheen": {"sheenColorFactor": [0.9, 0.4, 0.2],
                                 "sheenRoughnessFactor": 0.5,
                                 "sheenColorTexture": {"index": 0}}},
        None,
        {"sheen_color_factor": [0.9, 0.4, 0.2], "sheen_roughness_factor": 0.5}),
    "transmission_volume_ior": (
        {"KHR_materials_transmission": {"transmissionFactor": 0.9},
         "KHR_materials_volume": {"thicknessFactor": 0.05, "attenuationDistance": 0.3,
                                  "attenuationColor": [0.9, 0.3, 0.2]},
         "KHR_materials_ior": {"ior": 1.45}},
        None,
        {"transmission_factor": 0.9, "thickness_factor": 0.05, "attenuation_distance": 0.3,
         "attenuation_color": [0.9, 0.3, 0.2], "ior": 1.45}),
    "point_light": (
        None,
        {"type": "point", "color": [1.0, 0.8, 0.6], "intensity": 40.0, "range": 12.0},
        {"type": 0, "color": [1.0, 0.8, 0.6], "intensity": 40.0, "cutoff": 12.0}),
    "spot_light": (
        None,
        {"type": "spot", "color": [0.5, 0.6, 1.0], "intensity": 75.0,
         "spot": {"innerConeAngle": 0.2, "outerConeAngle": 0.6}},
        {"type": 1, "color": [0.5, 0.6, 1.0], "intensity": 75.0, "inner_angle": 0.2,
         "outer_angle": 0.6}),
}


@pytest.mark.parametrize("case", list(EXTENSIONS))
def test_extensions_reach_the_programs_loader(tmp_path, case):
    from gltf_renderer_tpu_torch.scene import types as T
    from gltf_renderer_tpu_torch.scene.gltf import _read_glb, load_gltf

    mat_ext, light, expect = EXTENSIONS[case]
    scene = textured_sphere.build(tex_size=16, n_lat=4, n_lon=8)
    if mat_ext is not None:
        scene["materials"][0]["extensions"] = mat_ext
        used = sorted(mat_ext)
    else:
        scene["nodes"].append(dict(mesh=-1, translation=[0.0, 2.0, 1.0],
                                   rotation=[0.0, 0.0, 0.0, 1.0], children=[],
                                   extensions={"KHR_lights_punctual": {"light": 0}}))
        scene["roots"] = [0, 1]
        scene["extensions"] = _light(light)
        used = ["KHR_lights_punctual"]
    scene["extensions_used"] = used
    path = write_glb(str(tmp_path / "s.glb"), scene)
    assert _read_glb(open(path, "rb").read())[0]["extensionsUsed"] == used
    loaded = load_gltf(path)
    if mat_ext is not None:
        table = loaded.materials._asdict()
        row = 1  # row 0 is the loader's default material
        for key, want in expect.items():
            np.testing.assert_array_equal(table[key][row], np.float32(want), err_msg=key)
        slots = {"clearcoat": T.TEX_CLEARCOAT, "sheen": T.TEX_SHEEN_COLOR}
        if case in slots:
            assert loaded.materials.tex_index[row, slots[case]] >= 0
    else:
        params = loaded.light_params._asdict()
        for key, want in expect.items():
            np.testing.assert_array_equal(params[key][0], np.asarray(want, params[key].dtype),
                                          err_msg=key)
        assert list(loaded.light_nodes) == [1] and loaded.nodes[1].light == 0
        np.testing.assert_array_equal(loaded.nodes[1].translation, [0.0, 2.0, 1.0])


RECORDER = '''

# The test's recorder: what the harness handed this copy.
SEEN = []
_settings, _accumulate = settings, accumulate


def settings(pt):
    SEEN.append(("settings", dict(pt)))
    return _settings(pt)


def accumulate(*a, **kw):
    SEEN.append(("accumulate", len(a[-1])))
    return _accumulate(*a, **kw)
'''


def test_a_configuration_brings_its_own_reference_and_reads_counts(monkeypatch, tmp_path):
    """A configuration, its reference package (a copy of the default, with
    a recorder), a cell and a metric on the program's per-frame counters,
    all added as files to a copy of the benchmark folder."""
    from gltf_renderer_tpu_torch.ops import traverse
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "perfbench"
    shutil.copytree(pb / "reference", pb / "reference_ball")
    with open(pb / "reference_ball" / "render.py", "a") as f:
        f.write(RECORDER)
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    cfg = json.load(open(pb / "configs" / "helmet.json"))
    cfg = dict(cfg, name="ball", reference="reference_ball")
    (pb / "configs" / "ball.json").write_text(json.dumps(cfg))
    (pb / "limits" / "ball.pt_still.json").write_text(
        (pb / "limits" / "helmet.pt_still.json").read_text())
    (pb / "metrics" / "k1_counted.pt.py").write_text(
        "def read(ctx):\n"
        "    counts = ctx['counts']\n"
        "    return float(sum(c['k1_launches'] for c in counts)) if counts else None\n")
    bench["configs"].append(dict(bench["configs"][1], name="ball",
                                 file="perfbench/configs/ball.json"))
    bench["workloads"].append({"name": "ball.pt_still", "config": "ball", "traffic": "still",
                               "chips": 1, "why": "a test cell"})
    for m in bench["per_layer"]:
        if m["name"] == "k1_launches_per_frame.pt":
            m["workloads"].append("ball.pt_still")
    bench["per_layer"].append({"name": "k1_counted.pt", "unit": "launches", "better": "lower",
                               "source": "program_counter", "layer": "Path tracer",
                               "moves": "pt_msamples_per_s", "workloads": ["ball.pt_still"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    # K1 counts its launches on the card only; here each traverse_wide call
    # stands in for one.
    orig = pt.traverse_wide

    @functools.wraps(orig)  # the K1 recorder binds its arguments by name
    def counted(*a, **kw):
        traverse.KERNEL_LAUNCHES += 1
        return orig(*a, **kw)

    monkeypatch.setattr(traverse, "KERNEL_LAUNCHES", traverse.KERNEL_LAUNCHES)
    monkeypatch.setattr(pt, "traverse_wide", counted)
    cpu_environment(monkeypatch)
    monkeypatch.setattr(harness, "PROFILED_FRAMES", 1)
    cell = tiny_cell("ball.pt_still", 16, 9, root=str(root))
    assert cell.reference == "reference_ball"
    res, lines = harness.run_cell(cell, 2 ** 32 + 21, 0, True, device="cpu")

    ref = spec.reference("reference_ball", str(pb))
    assert os.path.dirname(ref.pathtracer.__file__) == str(pb / "reference_ball")
    # Two warm frames, one in the zero-second window, two profiled after it.
    assert ref.SEEN == [("settings", cfg["pt"]), ("accumulate", 5)]
    assert "environment_mis" in ref.SEEN[0][1]  # a key the default reference does not read
    assert res["correct"], res["checks"]
    counted_k1 = res["metrics"]["k1_counted.pt"]["value"]
    assert counted_k1 > 0
    assert counted_k1 == res["metrics"]["k1_launches_per_frame.pt"]["value"] * res["attempted"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_packages_import_neither_jax_nor_the_program():
    packages = sorted(d for d in os.listdir(HERE)
                      if d.startswith("reference") and os.path.isdir(os.path.join(HERE, d)))
    assert "reference" in packages
    for name in packages:
        for f in sorted(os.listdir(os.path.join(HERE, name))):
            if not f.endswith(".py"):
                continue
            mods = set(_imports(os.path.join(HERE, name, f)))
            roots = {m.split(".")[0] for m in mods}
            assert not roots & (JAX_NAMES | {PROGRAM}), (name, f)
            # Its own modules relatively, so that a copy calls its own.
            assert not {m for m in mods if m.startswith(f"perfbench.{name}")}, (name, f)
