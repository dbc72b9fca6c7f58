"""The benchmark's own sources: what they import, the run-time guard, the
K1 byte count, and a cell added by files alone."""

from __future__ import annotations

import ast
import json
import os
import shutil
import sys
import types

import pytest

from perfbench import harness, spec
from perfbench.roofline import k1_bytes, path_bytes
from perfbench.tests.tiny import cpu_environment, tiny_cell

HERE = os.path.join(spec.ROOT, "perfbench")
JAX_NAMES = {"jax", "jaxlib", "flax", "gltf_renderer_tpu"}
PROGRAM = "gltf_renderer_tpu_torch"


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imported_roots(path)) & JAX_NAMES, path


def test_reference_imports_nothing_of_the_program():
    for path in _sources():
        rel = os.path.relpath(path, HERE)
        if rel.startswith("reference") or rel.startswith(("scenes", "skies", "metrics")) or rel in (
                "check.py", "glb.py", "frames.py", "roofline.py", "spec.py"):
            assert PROGRAM not in set(_imported_roots(path)), rel


def test_run_time_guard_names_jax_and_the_jax_package(monkeypatch):
    sys.path.insert(0, HERE)
    try:
        import run
    finally:
        sys.path.remove(HERE)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gltf_renderer_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "gltf_renderer_tpu_torch_extra", types.ModuleType("y"))
    assert run.forbidden_modules() == ["gltf_renderer_tpu", "jax"]


def test_k1_bytes_of_the_helmet_primary_launch():
    """PERF.md's helmet primary figure: 15.6 MB for 262,144 rays."""
    from gltf_renderer_tpu_torch.bench_scene import world_from_scene
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.scene.procedural import textured_sphere_scene

    sc = textured_sphere_scene(tex_size=64, n_lat=128, n_lon=192, metallic=0.3, roughness=0.45)
    world, lights = world_from_scene(sc)
    ps, _ = pt.make_pt_scene(world, sc.materials, sc.textures, lights, device="cpu")
    t = (ps.wide_nodes, ps.wide_maps.meta, ps.leaf_records, ps.leaf_words)
    tables = sum(x.numel() * x.element_size() for x in t)
    path = path_bytes(*(tuple(x.shape) + (x.element_size(),) for x in t))
    assert round(k1_bytes(262_144, False, tables, path, 262_144) / 1e6, 1) == 15.6
    # A hop launch: the whole chunk, a thousand rays live, few of the tables.
    assert k1_bytes(262_144, False, tables, path, 1000) == 262_144 * 48 + 1000 * path < 15.6e6


def test_a_cell_added_by_files_alone(monkeypatch, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    pb = root / "perfbench"
    cfg = json.load(open(pb / "configs" / "helmet.json"))
    (pb / "configs" / "ball.json").write_text(json.dumps(dict(cfg, name="ball")))
    (pb / "traffic" / "still_seeded.json").write_text(json.dumps(
        {"warm_frames": 1, "seed_stride": 12345}))
    (pb / "metrics" / "frames_drawn.pt.py").write_text(
        "def read(ctx):\n    return float(ctx['frames'])\n")
    (pb / "limits" / "ball.still_seeded.json").write_text(
        (pb / "limits" / "helmet.pt_still.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="ball",
                                 file="perfbench/configs/ball.json"))
    bench["workloads"].append({"name": "ball.still_seeded", "config": "ball",
                               "traffic": "still_seeded", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "frames_drawn.pt", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "Renderer",
                               "moves": "pt_msamples_per_s", "workloads": ["ball.still_seeded"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = tiny_cell("ball.still_seeded", 16, 9, root=str(root))
    assert cell.traffic["seed_stride"] == 12345 and cell.here == str(pb)
    assert [m["name"] for m in cell.per_layer][-1] == "frames_drawn.pt"
    cpu_environment(monkeypatch)
    monkeypatch.setattr(harness, "PROFILED_FRAMES", 1)
    res, lines = harness.run_cell(cell, 3, 0, True, device="cpu")
    # One warm frame, one in the zero-second window, two profiled after it
    # (device activity, then host operations): the check follows all four.
    assert "over 4 frames" in lines[0]
    assert res["correct"] and res["metrics"]["frames_drawn.pt"]["value"] == 1.0


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs on the chip")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["courtyard.pt_still", "helmet.pt_still"])
def test_cell_runs_correct_on_the_card(cuda_card, workload):
    import subprocess

    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", workload,
                          "--seed", str(2 ** 31 + 9), "--seconds", "3", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
