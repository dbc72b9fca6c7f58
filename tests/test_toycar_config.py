"""The ToyCar-class configuration (perfbench/configs/toycar.json) on the CPU,
at a tiny size: 40x24, 16^2 maps, the tessellation cut by 4, a 32x64 sky,
5 bounces with roulette from the third, both lights, 3 frames.

- The port's Renderer against the configuration's own reference
  (perfbench/reference_toycar) bit for bit: the accumulated mean and the u8
  frame at every pixel. The reference follows the port's sample stream and
  arithmetic, and both run the same torch ops on the same device, so no
  tolerance is needed.
- The comparison catches the port with a layer or a feature taken out:
  clearcoat, sheen or transmission (the scene's PTMeta flag off), light NEE
  (the sampled light's radiance zeroed), roulette's division by the
  continue probability, and transmitted bounces leaving from above the
  surface.
- reference_toycar imports neither JAX nor the port, and carries its own
  Sheen_E table.
- The scene's GLB reaches the port's loader with its five materials, the
  extension factors, the sheen map's texture transform and two lights.
- Tracing: with `profile` on a frame holds the `pt.bsdf_sample` span,
  lanes_shaded is the rows the bounces shaded (the path tracer compacts
  them to the live lanes), 0 < live_lanes <= lanes_shaded and some bounce
  compacted; with it off, no counts, and the ops a path-tracer chunk
  issues on the helmet and the courtyard are the recorded
  tools/count_ops.py counts, which hold no span or counter op.
- The two metric readers this configuration added.
"""

from __future__ import annotations

import ast
import functools
import inspect
import json
import math
import os

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch.render import pathtracer as pt
from gltf_renderer_tpu_torch.render import settings as S
from perfbench import frames, spec
from perfbench.glb import write_glb
from perfbench.reference import pathtracer as ref_pt
from perfbench.reference_toycar import render as toycar_ref
from perfbench.scenes import toycar
from perfbench.skies import analytic_sky

torch.set_num_threads(2)
W, H = 40, 24
HERE = os.path.join(spec.ROOT, "perfbench")
CONFIG = json.load(open(os.path.join(HERE, "configs", "toycar.json")))
# tools/count_ops.py's counts with profile off (ATen ops of one
# trace_chunked call at spp 4, 2 bounces, 32x18; a traversal counted as
# one). Before the path tracer compacted its rows to the live lanes they
# were 5936 and 7156: each bounce's count read and each compaction's
# gathers add 39 ops on the helmet (2 compactions) and 56 on the courtyard
# (3).
PARENT_OPS = {"helmet": {"ops": 5975, "traversals": 3, "chunks": 1},
              "courtyard": {"ops": 7212, "traversals": 6, "chunks": 1}}


@functools.lru_cache(maxsize=1)
def _inputs():
    return toycar.build(tex_size=16, scale=4), analytic_sky.build(32, 64)


def _view():
    cam = CONFIG["camera"]
    return ref_pt.look_at(cam["eye"], cam["target"])


def _seeds():
    traffic = frames.Traffic(json.load(open(os.path.join(HERE, "traffic", "still.json"))),
                             2 ** 32 + 23)
    return [traffic.frame_seed(i) for i in range(3)]


@pytest.fixture(scope="module")
def renderer(tmp_path_factory):
    from gltf_renderer_tpu_torch.env.environment import build_environment
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    scene, sky = _inputs()
    r = Renderer(S.RenderSettings(backend="pathtracer", width=W, height=H,
                                  pt=S.PathTracerSettings(**CONFIG["pt"])), device="cpu")
    r.load_scene(write_glb(str(tmp_path_factory.mktemp("toycar") / "toycar.glb"), scene))
    r.env = build_environment(sky, device="cpu", prefilters=False)
    r.camera.world_to_view = _view()
    r.camera.y_fov = math.radians(CONFIG["camera"]["y_fov_deg"])
    r.camera.z_near = CONFIG["camera"]["z_near"]
    r.draw_frame(seed=0)  # the path tracer's tables and PTMeta
    return r


def _draw(r):
    """The three frames from a fresh accumulation: (mean, last u8 frame)."""
    r._accum = None
    for s in _seeds():
        img = r.draw_frame(seed=s)
    return r._accum.clone(), img


@pytest.fixture(scope="module")
def reference():
    scene, sky = _inputs()
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    px, py = xx.ravel(), yy.ravel()
    cam = CONFIG["camera"]
    c2w = ref_pt.clip_to_world(_view(), math.radians(cam["y_fov_deg"]), W / H, cam["z_near"])
    ref = toycar_ref.build_scene(scene, sky, "cpu")
    acc = toycar_ref.accumulate(ref, toycar_ref.settings(CONFIG["pt"]), c2w, (W, H), px, py,
                                _seeds())
    return acc, px, py, c2w


def test_reference_matches_port_bit_for_bit(renderer, reference):
    acc, img = _draw(renderer)
    assert renderer._meta.has_sheen and renderer._meta.has_clearcoat
    assert renderer._meta.has_transmission and renderer._meta.num_lights == 2
    assert not renderer._meta.identity_uv  # the sheen map's transform is read
    ref_acc, px, py, c2w = reference
    assert np.array_equal(c2w, renderer.camera.clip_to_world())
    u8 = toycar_ref.frame_u8(ref_acc, px, py, renderer.frame_index - 1).numpy()
    torch.testing.assert_close(acc, ref_acc.reshape(H, W, 3), rtol=0, atol=0)
    np.testing.assert_array_equal(img, u8.reshape(H, W, 3))
    assert float(ref_acc.mean()) > 0.01


def _drop_meta(field):
    def fault(monkeypatch, r):
        monkeypatch.setattr(r, "_meta", r._meta._replace(**{field: False}))
    return fault


def _drop_light_nee(monkeypatch, r):
    """The sampled light's radiance zeroed (the random stream kept)."""
    orig = pt.sample_point_light

    def dark(*a, **kw):
        ray, pdf = orig(*a, **kw)
        return ray._replace(color=ray.color * 0.0), pdf

    monkeypatch.setattr(pt, "sample_point_light", dark)


def _trace_rays_with(old, new):
    """A fault: _trace_rays with one line of its source replaced."""
    def fault(monkeypatch, r):
        src = inspect.getsource(pt._trace_rays)
        assert src.count(old) == 1
        ns = {}
        exec(compile(src.replace(old, new), pt.__file__, "exec"), pt.__dict__, ns)
        monkeypatch.setattr(pt, "_trace_rays", ns["_trace_rays"])
    return fault


# roulette without its division by the continue probability
_drop_roulette_division = _trace_rays_with(
    "weight = weight / torch.where(cont, continue_prob,\n"
    + " " * 50 + "torch.ones_like(continue_prob)).unsqueeze(-1)", "pass")
# transmitted bounces leaving from above the surface, not below it
_transmission_origin_above = _trace_rays_with(
    "origin = torch.where(is_t.unsqueeze(-1), ray_origin_below, ray_origin)",
    "origin = ray_origin")


FAULTS = {"clearcoat": _drop_meta("has_clearcoat"), "sheen": _drop_meta("has_sheen"),
          "transmission": _drop_meta("has_transmission"), "light_nee": _drop_light_nee,
          "roulette_division": _drop_roulette_division,
          "transmission_origin": _transmission_origin_above}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_comparison_catches_the_fault(monkeypatch, renderer, reference, fault):
    FAULTS[fault](monkeypatch, renderer)
    acc, _ = _draw(renderer)
    ref_acc = reference[0].reshape(H, W, 3)
    assert not torch.equal(acc, ref_acc)
    # Not the scrub of one broken sample: finite values that differ on
    # several pixels (the glass covers 15 of the 960).
    differ = int((acc != ref_acc).any(-1).sum())
    assert torch.isfinite(acc).all() and differ >= 8, differ


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, 0) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def test_reference_imports_neither_jax_nor_the_port():
    pkg = os.path.join(HERE, "reference_toycar")
    files = sorted(f for f in os.listdir(pkg) if f.endswith(".py"))
    # Its own modules extend perfbench/reference's; the rest are that package's.
    assert set(files) == {"__init__.py", "render.py", "pathtracer.py", "world.py"}
    for f in files:
        for mod, level in _imports(os.path.join(pkg, f)):
            if level == 2:
                assert mod.split(".")[0] == "reference", (f, mod)  # the sibling reference
            if level:
                continue  # its own modules, relatively
            root = mod.split(".")[0]
            assert root in {"__future__", "os", "typing", "numpy", "torch"}, (f, mod)
    # Its own copy of the Sheen_E table (and its licence), the port's values.
    from gltf_renderer_tpu_torch.ops.bsdf import sheen_e_table

    assert os.path.isfile(os.path.join(pkg, "SHEEN_E_LICENSE.txt"))
    from perfbench.reference_toycar import pathtracer as tp

    assert os.path.dirname(tp.SHEEN_E) == pkg
    np.testing.assert_array_equal(tp.load_sheen_e("cpu").numpy(), sheen_e_table())
    cell = spec.load_cell("toycar.pt_still")
    assert cell.reference == "reference_toycar"
    assert spec.reference(cell.reference, cell.here) is toycar_ref


def test_glb_reaches_the_ports_loader(tmp_path):
    from gltf_renderer_tpu_torch.scene import types as T
    from gltf_renderer_tpu_torch.scene.gltf import load_gltf

    scene, _ = _inputs()
    loaded = load_gltf(write_glb(str(tmp_path / "t.glb"), scene))
    m = loaded.materials
    assert len(m.ior) == 6  # five and the loader's default at row 0
    body, fabric, glass, chrome, tyres = range(1, 6)
    np.testing.assert_array_equal(m.clearcoat_factor[1:], np.float32([1, 0, 0, 0, 0]))
    assert m.clearcoat_roughness_factor[body] == np.float32(0.06)
    assert m.tex_index[body, T.TEX_CLEARCOAT] >= 0
    np.testing.assert_array_equal(m.sheen_color_factor[fabric], np.float32([1, 1, 1]))
    assert m.sheen_roughness_factor[fabric] == np.float32(0.5)
    assert m.tex_index[fabric, T.TEX_SHEEN_COLOR] >= 0
    np.testing.assert_array_equal(m.tex_scale[fabric, T.TEX_SHEEN_COLOR], np.float32([8, 8]))
    np.testing.assert_array_equal(m.tex_scale[fabric, T.TEX_ALBEDO], np.float32([1, 1]))
    np.testing.assert_array_equal(m.transmission_factor[1:], np.float32([0, 0, 1, 0, 0]))
    assert m.ior[glass] == np.float32(1.5)
    assert m.flags[glass] & T.MATERIAL_FLAG_DOUBLE_SIDED
    assert m.metalness_factor[chrome] == 1.0 and m.tex_index[chrome].max() < 0
    assert all(m.tex_index[tyres, s] >= 0
               for s in (T.TEX_ALBEDO, T.TEX_NORMAL, T.TEX_METALLIC_ROUGHNESS))
    assert len(loaded.textures.x) == 10
    lp = loaded.light_params
    assert list(lp.type) == [T.LIGHT_TYPE_POINT, T.LIGHT_TYPE_SPOT]
    np.testing.assert_array_equal(lp.cutoff, np.float32([12.0, 14.0]))
    assert len(loaded.light_nodes) == 2


def test_full_size_configuration():
    """The configuration as the cell runs it: its triangle count as its
    files state it."""
    full = toycar.parts(1)
    n = sum(len(p[3]) // 3 for ps in full.values() for p in ps)
    assert n == 178_688 and "178,688" in CONFIG["geometry"]
    assert 120_000 <= n <= 200_000
    assert CONFIG["pt"]["max_bounces"] == 5 and CONFIG["pt"]["min_bounces"] == 2
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    cell = next(w for w in bench["workloads"] if w["name"] == "toycar.pt_still")
    assert cell["chips"] == 1 and cell["traffic"] == "still"


def test_profile_on_counts_lanes_and_times_the_bsdf_sample(monkeypatch, renderer):
    shaded = []
    fetch = pt.fetch_hit_attributes

    def counted(world, tri, *a, **kw):
        shaded.append(tri.shape[0])
        return fetch(world, tri, *a, **kw)

    monkeypatch.setattr(pt, "fetch_hit_attributes", counted)
    renderer.profile = True
    try:
        renderer.draw_frame(seed=5)
    finally:
        renderer.profile = False
    ms, counts = renderer.stats["pass_ms"], renderer.stats["counts"]
    assert ms["pt.bsdf_sample"] >= 0.0 and "pt.shade" in ms
    rows = pt._tile_order(W, H, torch.device("cpu"))[0].shape[0]
    assert counts["lanes_shaded"] == sum(shaded) < rows * len(shaded)
    assert 0 < counts["live_lanes"] <= counts["lanes_shaded"]
    assert counts["compactions"] > 0
    renderer.draw_frame(seed=6)
    assert "counts" not in renderer.stats and "pass_ms" not in renderer.stats


@pytest.mark.parametrize("kind", sorted(PARENT_OPS))
def test_profile_off_issues_the_parents_ops(kind):
    from gltf_renderer_tpu_torch import bench_scene as bs
    from gltf_renderer_tpu_torch.tools import count_ops

    # count_ops' scenes; the raster backend's diffuse prefilter, which the
    # path tracer never reads, at 8^2 rather than 256^2 texels.
    built = bs.build_bench_scene(*count_ops.RES, device="cpu", scene_kind=kind,
                                 **dict(count_ops.SMALL, diffuse_size=8))
    assert count_ops.count(*built[:5]) == PARENT_OPS[kind]


def _frames(**counts):
    return [dict(counts, k1_launches=7, alpha_hops=0, alpha_reads=0, chunks=1)]


@pytest.mark.parametrize("name, ctx, want", [
    ("bsdf_sample_issue_ms.pt", {"pass_ms": [{"pt.chunk": 9.0, "pt.bsdf_sample": 2.0},
                                             {"pt.chunk": 8.0, "pt.bsdf_sample": 4.0}]}, 3.0),
    ("bsdf_sample_issue_ms.pt", {"pass_ms": [{"pt.chunk": 9.0, "pt.shade": 2.0}]}, None),
    ("live_lane_pct.pt", {"counts": _frames(live_lanes=30, lanes_shaded=120)
                          + _frames(live_lanes=10, lanes_shaded=40)}, 25.0),
    ("live_lane_pct.pt", {"counts": _frames()}, None),
    ("live_lane_pct.pt", {"counts": []}, None),
])
def test_metric_readers(name, ctx, want):
    read = spec.metric_reader(name, HERE)
    got = read(ctx)
    assert got == pytest.approx(want) if want is not None else got is None
