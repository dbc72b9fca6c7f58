"""The path tracer's live-lane compaction (render/pathtracer._trace_rays),
on the CPU at small sizes.

After a bounce's miss step `_trace_rays` gathers the ray state to the live
lanes when some lane has died, shades, samples and traces those rows alone
(a bounce whose lanes are all alive, or all dead, keeps its rows). The
image is the one every row would give, so each rendered case is held bit
for bit against the plain references of perfbench, which trace every lane
of every bounce and share no code with the port (`perfbench/reference`
for the helmet and courtyard configurations, `perfbench/reference_toycar`
for the toycar's):

- the mostly-miss textured sphere (the helmet's: bounce 0 compacts), the
  alpha-MASKed courtyard at 64x32 looking down at its floor, where no tile
  is padded and every primary ray hits, so bounce 0 stays whole and the
  masked retry runs on compacted rows after it (and down the colonnade,
  where 89% hit and bounce 0 compacts too), and the toycar at 5 bounces
  (roulette, the merged light shadows, the last bounce's own light
  shadow);
- 2 samples a pixel in one call (the seed a vector, gathered with the
  rows), and a tile placed by `pixel_offset` / `full_resolution`;
- a camera that sees only sky (every lane dead after the first miss step,
  so no bounce compacts), and roulette that leaves no lane before the last
  bounce; both make the launches every bounce made before;
- alpha shadows, which no reference has: the foliage's point light through
  its masked leaf, compacted against the same trace with compaction off,
  bit for bit, with the same hops and launches;
- the rule: the courtyard's bounce 0 stays whole with every lane alive and
  compacts once one has died;
- the counters of a profiled frame: `lanes_shaded` is the rows the
  bounces shaded, `live_lanes == lanes_shaded` where every bounce
  compacts or is all alive, and `compactions` counts the bounces that
  compacted.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch.ops import rng
from gltf_renderer_tpu_torch.render import pathtracer as pt
from gltf_renderer_tpu_torch.render import settings as S
from gltf_renderer_tpu_torch.utils import spans
from perfbench import harness, spec
from perfbench.glb import write_glb
from perfbench.reference import pathtracer as ref_pt
from perfbench.reference import render as ref_render
from perfbench.reference_toycar import render as toycar_ref
from perfbench.scenes import toycar
from perfbench.skies import analytic_sky
from perfbench.tests.tiny import tiny_cell

torch.set_num_threads(2)
SEEDS = (3_124_000_001, 0x9E3779B9 * 11 & 0xFFFFFFFF)
# (workload, width, height, camera target): the helmet with padded tiles,
# where bounce 0 compacts, and the courtyard at whole 32x32 tiles looking
# down at its floor, where bounce 0 is all alive and does not.
SIZES = {"helmet": ("helmet.pt_still", 40, 24, None),
         "courtyard": ("courtyard.pt_still", 64, 32, [-7.0, 0.0, 0.0])}
COLONNADE = [1.0, 0.0, 0.5]  # the courtyard down its colonnade: 89% of the primary rays hit


class Setup:
    """The port's tables (through the Renderer, as the benchmark builds
    them) and the reference's scene, for one configuration at (w, h)."""

    def __init__(self, name, w, h, scene, sky, cfg, ref_mod, tmp, target=None):
        from gltf_renderer_tpu_torch.env.environment import build_environment
        from gltf_renderer_tpu_torch.render.renderer import Renderer

        self.w, self.h, self.cfg, self.ref_mod, self.target = w, h, cfg, ref_mod, target
        r = Renderer(S.RenderSettings(backend="pathtracer", width=w, height=h,
                                      pt=S.PathTracerSettings(**cfg["pt"])), device="cpu")
        r.load_scene(write_glb(os.path.join(tmp, f"{name}.glb"), scene))
        r.env = build_environment(sky, device="cpu", prefilters=False)
        cam = cfg["camera"]
        r.camera.world_to_view = ref_pt.look_at(cam["eye"], target or cam["target"])
        r.camera.y_fov = math.radians(cam["y_fov_deg"])
        r.camera.z_near = cam["z_near"]
        r.draw_frame(seed=0)  # the tables and PTMeta
        assert np.array_equal(r.camera.clip_to_world(), self.c2w())
        self.r = r
        self.ref = ref_mod.build_scene(scene, sky, "cpu")

    def c2w(self, eye=None, target=None):
        cam = self.cfg["camera"]
        target = target or self.target or cam["target"]
        return ref_pt.clip_to_world(ref_pt.look_at(eye or cam["eye"], target),
                                    math.radians(cam["y_fov_deg"]), self.w / self.h,
                                    cam["z_near"])

    def port(self, c2w, seed, pt_cfg=None, **kw):
        """The port's (h, w, 3) radiance of one trace call."""
        settings = S.PathTracerSettings(**(pt_cfg or self.cfg["pt"]))
        spp = kw.pop("spp", 1)
        res = kw.pop("resolution", (self.w, self.h))
        return pt.trace_chunked(self.r._ptscene, self.r._meta, settings, self.r.params, c2w,
                                res, seed, spp=spp, **kw)

    def reference(self, c2w, seed, px, py, pt_cfg=None):
        """The reference's (P, 3) radiance of one sample at (px, py)."""
        settings = self.ref_mod.settings(pt_cfg or self.cfg["pt"])
        return self.ref_mod.accumulate(self.ref, settings, c2w, (self.w, self.h), px, py, [seed])


def _pixels(w, h, ox=0, oy=0):
    yy, xx = np.meshgrid(np.arange(h) + oy, np.arange(w) + ox, indexing="ij")
    return xx.ravel(), yy.ravel()


def _setup(name, tmp):
    if name == "toycar":
        cfg = json.load(open(os.path.join(spec.ROOT, "perfbench", "configs", "toycar.json")))
        scene, sky = toycar.build(tex_size=16, scale=4), analytic_sky.build(32, 64)
        return Setup(name, 40, 24, scene, sky, cfg, toycar_ref, tmp)
    workload, w, h, target = SIZES[name]
    cell = tiny_cell(workload, w, h)
    scene, sky = harness.make_inputs(cell)
    return Setup(name, w, h, scene, sky, cell.config, ref_render, tmp, target)


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """The three configurations, built before any test's spy counts."""
    tmp = str(tmp_path_factory.mktemp("compaction"))
    return {name: _setup(name, tmp) for name in ("helmet", "courtyard", "toycar")}


@pytest.fixture
def spy(monkeypatch):
    """Rows each bounce shades (fetch_hit_attributes' rows), the lanes
    alive among them (count_lanes' masks), K1 launches (traverse_wide
    calls) and the compactions, over the test's calls."""
    seen = {"rows": [], "live": [], "k1": 0, "compactions": pt.COMPACTIONS}
    fetch, traverse, count = pt.fetch_hit_attributes, pt.traverse_wide, spans.count_lanes

    def fetched(world, tri, *a, **kw):
        seen["rows"].append(tri.shape[0])
        return fetch(world, tri, *a, **kw)

    def traced(*a, **kw):
        seen["k1"] += 1
        return traverse(*a, **kw)

    def counted(alive):
        seen["live"].append(int(alive.sum()))
        return count(alive)

    monkeypatch.setattr(pt, "fetch_hit_attributes", fetched)
    monkeypatch.setattr(pt, "traverse_wide", traced)
    monkeypatch.setattr(spans, "count_lanes", counted)
    return seen


def _assert_bits(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["helmet", "courtyard", "toycar"])
def test_compacted_frame_is_the_references(setups, spy, name):
    s = setups[name]
    c2w = s.c2w()
    px, py = _pixels(s.w, s.h)
    hops = pt.ALPHA_RETRY_HOPS
    for seed in SEEDS:
        spy["rows"].clear()
        spy["live"].clear()
        got = s.port(c2w, seed).reshape(-1, 3)
        _assert_bits(got, s.reference(c2w, seed, px, py))
        padded = pt._tile_order(s.w, s.h, torch.device("cpu"))[0].shape[0]
        # bounce 0 compacts where its tiles are padded or most rays miss
        assert (spy["rows"][0] < padded) == (name != "courtyard"), spy["rows"]
        assert len(spy["rows"]) == s.cfg["pt"]["max_bounces"] + 1
        assert all(a >= b for a, b in zip(spy["rows"], spy["rows"][1:]))
        # a compacted bounce shades its live lanes alone
        assert spy["live"][1] == spy["rows"][1] > 0
    assert pt.COMPACTIONS > spy["compactions"]
    assert float(got.mean()) > 0.01
    if name == "courtyard":
        assert pt.ALPHA_RETRY_HOPS > hops  # the masked retry ran on compacted rows


def test_two_samples_a_pixel_in_one_call(setups, spy):
    """spp 2: the chunk holds both samples' rows, each keyed by its own
    seed, and the seed vector is gathered with the rows."""
    s = setups["helmet"]
    c2w = s.c2w()
    px, py = _pixels(s.w, s.h)
    got = s.port(c2w, SEEDS[0], spp=2).reshape(-1, 3)
    r0 = s.reference(c2w, SEEDS[0], px, py)
    r1 = s.reference(c2w, (SEEDS[0] + pt.SEED_STRIDE) & rng.M32, px, py)
    _assert_bits(got, (r0 + r1) / 2)
    assert pt.COMPACTIONS > spy["compactions"]


def test_tile_placed_in_its_image(setups, spy):
    s = setups["toycar"]
    c2w = s.c2w()
    ox, oy, tw, th = 8, 5, 24, 14
    got = s.port(c2w, SEEDS[1], resolution=(tw, th), pixel_offset=(ox, oy),
                 full_resolution=(s.w, s.h))
    px, py = _pixels(tw, th, ox, oy)
    _assert_bits(got.reshape(-1, 3), s.reference(c2w, SEEDS[1], px, py))
    assert pt.COMPACTIONS > spy["compactions"]


def test_sky_only_camera(setups, spy):
    """Every lane is dead after the first miss step: no bounce compacts (a
    bounce with no live lane keeps its rows), and each makes its launch."""
    s = setups["helmet"]
    c2w = s.c2w(eye=[1.1, -1.1, 0.6], target=[3.0, -3.0, 3.0])
    px, py = _pixels(s.w, s.h)
    got = s.port(c2w, SEEDS[0]).reshape(-1, 3)
    _assert_bits(got, s.reference(c2w, SEEDS[0], px, py))
    bounces = s.cfg["pt"]["max_bounces"] + 1
    assert spy["live"] == [0] * bounces and spy["k1"] == bounces
    assert pt.COMPACTIONS == spy["compactions"]
    assert float(got.min()) > 0.0  # the sky, everywhere


def test_every_lane_dies_before_the_last_bounce(setups, spy):
    """Roulette from bounce 1 of 6 on the sphere: no lane is left before
    the last bounce; the bounces after keep the rows they had."""
    s = setups["helmet"]
    cfg = dict(s.cfg["pt"], max_bounces=6, min_bounces=1)
    c2w = s.c2w()
    px, py = _pixels(s.w, s.h)
    got = s.port(c2w, SEEDS[1], pt_cfg=cfg).reshape(-1, 3)
    _assert_bits(got, s.reference(c2w, SEEDS[1], px, py, pt_cfg=cfg))
    assert spy["live"][0] > 0 and spy["live"][-2:] == [0, 0], spy["live"]
    assert spy["rows"][-1] == spy["rows"][-2] > 0
    assert spy["k1"] == cfg["max_bounces"] + 1  # the primary and one a bounce, as before


def test_alpha_shadows_compacted_equal_whole_rows(monkeypatch, spy):
    """The foliage's point light seen through its alpha-MASKed leaf with
    alpha shadows (the hop loops on compacted rows) against the same trace
    with compaction off: the same bits, hops and launches."""
    from gltf_renderer_tpu_torch.camera import look_at
    from gltf_renderer_tpu_torch.render.renderer import Renderer
    from gltf_renderer_tpu_torch.scene.procedural import foliage_scene

    settings = S.PathTracerSettings(max_bounces=2, min_bounces=2, alpha_shadows=True)
    r = Renderer(S.RenderSettings(width=48, height=32, pt=settings), device="cpu")
    r.load_scene(foliage_scene())
    r.camera.aspect_ratio = 48 / 32
    r.camera.z_near = 0.01
    r.camera.world_to_view = look_at([0.0, -4.0, 1.0], [0.0, 0.0, -0.5])
    r.draw_frame()
    assert r._meta.has_masked and r._meta.num_lights == 1
    c2w = r.camera.clip_to_world()
    runs = []
    for rule in (pt._live_lanes, lambda alive: None):
        monkeypatch.setattr(pt, "_live_lanes", rule)
        hops = (pt.ALPHA_RETRY_HOPS, pt.ALPHA_SHADOW_HOPS)
        k1, compactions = spy["k1"], pt.COMPACTIONS
        img, stats = pt.trace(r._ptscene, r._meta, settings, r.params, c2w, (48, 32), 7,
                              with_stats=True)
        runs.append((img, stats, pt.ALPHA_RETRY_HOPS - hops[0], pt.ALPHA_SHADOW_HOPS - hops[1],
                     spy["k1"] - k1, pt.COMPACTIONS - compactions))
    (img, stats, *counts), (img0, stats0, *counts0) = runs
    _assert_bits(img, img0)
    _assert_bits(stats, stats0)  # the same ray count
    assert counts[:3] == counts0[:3] and counts[1] > 0
    assert counts[3] > 0 == counts0[3]


@pytest.mark.parametrize("name", ["helmet", "courtyard"])
def test_profiled_frame_counts_the_rows_shaded(setups, spy, name):
    s = setups[name]
    r = s.r
    r.profile = True
    spy["rows"].clear()
    try:
        r.draw_frame(seed=SEEDS[0])
    finally:
        r.profile = False
    counts = r.stats["counts"]
    assert counts["lanes_shaded"] == sum(spy["rows"]) > 0
    assert counts["compactions"] == pt.COMPACTIONS - spy["compactions"] > 0
    if name == "helmet":  # every bounce compacts
        assert counts["compactions"] == len(spy["rows"])
    else:  # bounce 0, all alive, is shaded whole; the bounces after it compact
        assert counts["compactions"] == len(spy["rows"]) - 1
        assert spy["rows"][0] == s.w * s.h
    # every row shaded is alive: those of the bounces that compacted, and
    # the courtyard's whole bounce 0
    assert counts["live_lanes"] == counts["lanes_shaded"]


def test_rule_compacts_once_a_lane_has_died(setups, spy):
    """The courtyard's bounce 0 with every lane alive (its floor) is shaded
    whole; with 11% of its lanes dead (down the colonnade) it compacts.
    The image is the reference's either way."""
    s = setups["courtyard"]
    bounces = s.cfg["pt"]["max_bounces"]
    for target, compacted in ((None, bounces), (COLONNADE, bounces + 1)):
        c2w = s.c2w(target=target)
        px, py = _pixels(s.w, s.h)
        spy["live"].clear()
        spy["rows"].clear()
        compactions = pt.COMPACTIONS
        _assert_bits(s.port(c2w, SEEDS[0]).reshape(-1, 3), s.reference(c2w, SEEDS[0], px, py))
        assert pt.COMPACTIONS - compactions == compacted
        assert (spy["live"][0] == s.w * s.h) == (target is None)
        assert spy["rows"][0] == (s.w * s.h if target is None else spy["live"][0])
