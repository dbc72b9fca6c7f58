"""Torch port of the bench entry point (gltf_renderer_tpu_torch/bench.py)
and its warm-up (ops/warm.py), on the CPU at a small size.

The bench's output contract is held against the root bench.py's: exactly
one JSON line on stdout with the same keys, and a detail line on stderr
with the same fields plus the port's `kernel_launches`. The bench scene is
built small (64x36, 720 triangles, a tiny environment); the fidelity probe
and the raster probe run on the card (chip_smoke.py) and, piece by piece,
in the other port tests.
"""

import ast
import json
import os

import pytest
import torch

from gltf_renderer_tpu_torch import bench
from gltf_renderer_tpu_torch.bench_scene import build_bench_scene
from gltf_renderer_tpu_torch.ops import warm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (64, 36)


def _jax_bench_keys():
    """(result keys, detail keys, gate keys) of the root bench.py, read
    from its source (importing it would import JAX's device setup)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    dicts = [n for n in ast.walk(main) if isinstance(n, ast.Dict)]

    def keys(d):
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}

    result = next(keys(d) for d in dicts if "metric" in keys(d) and "vs_baseline" in keys(d)
                  and len(d.keys) == 4 and "value" in keys(d))
    detail = next(keys(d) for d in dicts if "resolution" in keys(d))
    gates = next(keys(d) for d in dicts if "nan_pixels_zero" in keys(d))
    return result, detail, gates


@pytest.fixture(scope="module")
def small_scene():
    return build_bench_scene(*RES, device="cpu", tex_size=64, n_lat=16, n_lon=24,
                             sky_hw=(32, 64), cube_size=16, diffuse_size=8)


def test_warm_ref_gives_ones():
    x = torch.zeros(warm.WARM_SHAPE)
    y = warm.warm_ref(x)
    assert y.dtype == torch.float32 and bool((y == 1.0).all())
    assert bool((warm.warm("cpu") == 1.0).all())  # the wrapper's CPU route
    with pytest.raises(TypeError):
        warm.add_one(torch.zeros(4, dtype=torch.float64))


def test_run_prints_the_bench_contract(small_scene, capsys):
    out = bench.run(small_scene, *RES, steps=1, spp=4, device="cpu", ssim_probe=False,
                    raster_probe=False)
    stdout, stderr = capsys.readouterr()
    lines = stdout.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    detail_lines = [x for x in stderr.splitlines() if x.startswith('{"detail"')]
    assert len(detail_lines) == 1
    detail = json.loads(detail_lines[0])["detail"]

    want_result, want_detail, want_gates = _jax_bench_keys()
    assert set(result) == want_result
    assert set(detail) == want_detail | {"kernel_launches", "alpha_hops"}
    assert set(detail["gates"]) == want_gates
    assert result["metric"] == "pt_mrays_per_s_per_chip_1080p"
    assert result["value"] > 0 and result["unit"] == "Mrays/s"
    assert abs(result["vs_baseline"] - result["value"] / 50.0) < 1e-4
    assert detail["resolution"] == list(RES) and detail["steps"] == 1
    assert detail["device"] == "cpu" and detail["rays"] > RES[0] * RES[1] * 4
    assert detail["nan_pixels"] == 0.0 and detail["gates"]["nan_pixels_zero"] is True
    assert detail["ssim_vs_cpu_32spp"] is None and detail["gates"]["ssim_ge_0995"] is None
    assert detail["raster_fps"] is None and len(detail["step_s"]) == 1
    assert out["detail"] == detail
    # On the CPU the wrappers take the plain versions: no kernel launches.
    assert set(detail["kernel_launches"].values()) == {0}


def test_raster_probe_runs_raycast_frames(small_scene):
    scene, meta, _, params, c2w, _ = small_scene
    fps = bench.measure_raster_fps(scene, meta, params, c2w, RES, "cpu", frames=1)
    assert fps > 0


def test_courtyard_bench_runs(monkeypatch, capsys):
    """BENCH_SCENE=courtyard through bench.main at 32x18, one step: the
    courtyard metric, no NaN, and the masked-retry loop reached."""
    for k, v in dict(BENCH_SCENE="courtyard", BENCH_WIDTH="32", BENCH_HEIGHT="18",
                     BENCH_STEPS="1").items():
        monkeypatch.setenv(k, v)
    assert bench.main(device="cpu") == 0
    stdout, stderr = capsys.readouterr()
    lines = stdout.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    detail = json.loads(next(x for x in stderr.splitlines()
                             if x.startswith('{"detail"')))["detail"]
    assert result["metric"] == "pt_mrays_per_s_courtyard_1080p" and result["value"] > 0
    assert detail["triangles"] == 273856 and detail["gates"]["nan_pixels_zero"] is True
    assert detail["ssim_vs_cpu_32spp"] is None and detail["raster_fps"] is None
    assert detail["alpha_hops"]["retry"] > 0 and detail["alpha_hops"]["shadow"] == 0
