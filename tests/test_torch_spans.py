"""The program's spans (gltf_renderer_tpu_torch/utils/spans.py) through the
Renderer's path-traced frames, on the CPU at 48x32, and the benchmark's
readers of them.

- A frame of the alpha-MASKed foliage scene (`procedural.foliage_scene`,
  the scene tests/test_torch_alpha.py holds equal to the JAX loader's,
  with its point light and alpha shadows) with `profile` on: every span in
  pass_ms, each >= 0, `pt.alpha_read` <= `pt.chunk` <= `path_trace_scene`;
  counts: K1 launches and alpha hops as the module counters' deltas, alpha
  reads as the `host_read` calls.
- An opaque scene: no alpha read, in the spans or the counts.
- Tracing off: no pass_ms or counts, no profiler range made, and
  `span` hands out the one shared no-op context.
- Under torch.profiler with `profile` off: the spans are profiler ranges
  (`draw_frame` around the frame, one `pt.chunk` a chunk) of operator
  scope, so the trace holds no user annotation (which the profiler mirrors
  onto the device timeline), and the frame records nothing.
- The CLI: `--profile` logs each frame's span ms and counts, and
  `--trace-dir` writes a trace that holds the spans.
- perfbench/metrics' four span readers on hand-made frames.
"""

import glob
import logging
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gltf_renderer_tpu_torch.app import cli
from gltf_renderer_tpu_torch.camera import look_at
from gltf_renderer_tpu_torch.ops import traverse
from gltf_renderer_tpu_torch.render import pathtracer as pt
from gltf_renderer_tpu_torch.render import settings as S
from gltf_renderer_tpu_torch.render.renderer import Renderer
from gltf_renderer_tpu_torch.scene.procedural import (
    foliage_scene,
    textured_sphere_scene,
    write_box_gltf,
)
from gltf_renderer_tpu_torch.utils import spans
from perfbench import spec

torch.set_num_threads(2)
W, H = 48, 32
USER_SCOPE = int(torch._C._profiler.RecordScope.USER_SCOPE)  # record_function's ranges
PT_SPANS = {"pt.chunk", "pt.k1", "pt.alpha_read", "pt.shade", "pt.nee", "pt.bsdf_sample",
            "u8_copy"}


def _renderer(scene):
    r = Renderer(S.RenderSettings(width=W, height=H, pt=S.PathTracerSettings(
        max_bounces=1, min_bounces=1, alpha_shadows=True)), device="cpu")
    r.load_scene(scene)
    r.camera.aspect_ratio = W / H
    r.camera.z_near = 0.01
    r.camera.world_to_view = look_at([0.0, -4.0, 1.0], [0.0, 0.0, -0.5])
    return r


@pytest.fixture
def launches(monkeypatch):
    """traverse_wide calls counted as K1 launches (the plain version runs
    on the CPU and counts none), and the host_read calls."""
    seen = {"k1": 0, "reads": 0}
    real_traverse, real_read = pt.traverse_wide, spans.host_read

    def counted(*a, **kw):
        seen["k1"] += 1
        traverse.KERNEL_LAUNCHES += 1
        return real_traverse(*a, **kw)

    def read(mask):
        seen["reads"] += 1
        return real_read(mask)

    monkeypatch.setattr(pt, "traverse_wide", counted)
    monkeypatch.setattr(spans, "host_read", read)
    # The counted launches leave the module counter as it was.
    monkeypatch.setattr(traverse, "KERNEL_LAUNCHES", traverse.KERNEL_LAUNCHES)
    return seen


def _hops():
    return pt.ALPHA_RETRY_HOPS + pt.ALPHA_SHADOW_HOPS


def test_masked_frame_spans_and_counts(launches):
    r = _renderer(foliage_scene())
    r.draw_frame()
    r.profile = True
    hops_0 = _hops()
    launches.update(k1=0, reads=0)
    r.draw_frame()
    ms, counts = r.stats["pass_ms"], r.stats["counts"]
    assert set(ms) == {"skin_and_refit", "path_trace_scene", "post(bloom+tonemap)"} | PT_SPANS
    assert all(v >= 0 for v in ms.values())
    assert ms["pt.alpha_read"] <= ms["pt.chunk"] <= ms["path_trace_scene"]
    assert counts["alpha_hops"] == _hops() - hops_0 > 0
    assert counts["k1_launches"] == launches["k1"] > 0
    assert counts["alpha_reads"] == launches["reads"] > counts["alpha_hops"]


def test_opaque_frame_has_no_alpha_read(launches):
    r = _renderer(textured_sphere_scene())
    r.profile = True
    r.draw_frame()
    ms, counts = r.stats["pass_ms"], r.stats["counts"]
    assert ms.get("pt.alpha_read", 0.0) == 0.0
    assert counts["alpha_reads"] == 0 and counts["alpha_hops"] == 0
    assert counts["k1_launches"] == launches["k1"] > 0


def test_tracing_off_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(spans, "_Range", refuse)
    r = _renderer(foliage_scene())
    r.draw_frame()
    assert "pass_ms" not in r.stats and "counts" not in r.stats
    assert spans.span("pt.chunk") is spans.span("u8_copy")


def test_spans_are_profiler_ranges():
    r = _renderer(foliage_scene())
    r.draw_frame()
    k1_0 = traverse.REFERENCE_CALLS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.draw_frame()
    k1 = traverse.REFERENCE_CALLS - k1_0
    names = [e.name for e in prof.events()]
    assert names.count("draw_frame") == 1 and names.count("pt.chunk") == 1
    assert names.count("pt.k1") == k1 > 0
    assert {"pt.shade", "pt.nee", "pt.alpha_read", "u8_copy", "path_trace_scene"} <= set(names)
    assert "pass_ms" not in r.stats
    assert not any(e.scope == USER_SCOPE for e in prof.events())
    # One pt.chunk a chunk of rays; outside a frame record nothing is kept.
    st = r.settings.pt
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.trace(r._ptscene, r._meta, st, r.params, r.camera.clip_to_world(), (W, H), 7,
                 chunk=512)
    chunks = math.ceil(pt._tile_order(W, H, torch.device("cpu"))[0].shape[0] / 512)
    assert [e.name for e in prof.events()].count("pt.chunk") == chunks == 4


def test_cli_profile_log_and_trace(tmp_path, caplog):
    box = write_box_gltf(str(tmp_path / "box.gltf"))
    caplog.set_level(logging.INFO)
    assert cli.main(["--gltf", box, "--width", str(W), "--height", str(H), "--spp", "1",
                     "--output", str(tmp_path / "box.png"), "--profile",
                     "--trace-dir", str(tmp_path / "traces")], device="cpu") == 0
    line = next(m for m in caplog.messages if "passes:" in m)
    assert "pt.chunk=" in line and "ms" in line.split("pt.chunk=")[1].split()[0]
    assert "alpha_reads=0" in line.split() and "k1_launches=0" in line.split()
    assert "chunks=1" in line.split()
    traces = glob.glob(str(tmp_path / "traces" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        text = f.read()
    assert '"draw_frame"' in text and '"pt.chunk"' in text


def _frames(*chunks):
    base = {"skin_and_refit": 1.0, "path_trace_scene": 20.0, "u8_copy": 0.5}
    return [dict(base, **c) for c in chunks]


FRAMES = _frames({"pt.chunk": 18.0, "pt.alpha_read": 3.0, "pt.shade": 6.0, "pt.nee": 2.0,
                  "pt.k1": 1.5},
                 {"pt.chunk": 16.0, "pt.shade": 5.0, "pt.k1": 0.5})


@pytest.mark.parametrize("name, want, want_opaque", [
    ("pt_issue_ms.pt", (15.0 + 16.0) / 2, 16.0),
    ("alpha_read_ms.pt", 3.0 / 2, 0.0),
    ("shade_issue_ms.pt", (8.0 + 5.0) / 2, 5.0),
    ("k1_issue_ms.pt", (1.5 + 0.5) / 2, 0.5),
])
def test_span_metric_readers(name, want, want_opaque):
    read = spec.metric_reader(name, spec.ROOT + "/perfbench")
    assert np.isclose(read({"pass_ms": FRAMES}), want)
    assert np.isclose(read({"pass_ms": FRAMES[1:]}), want_opaque)
    # A program without the spans: the old three passes only.
    old = [{k: v for k, v in p.items() if not k.startswith("pt.")} for p in FRAMES]
    assert read({"pass_ms": old}) is None
