"""The reference agrees with the port's path tracer on tiny scenes on the
CPU, and the frozen scene generators and the GLB writer give the scenes
the program's own generators and loader give."""

from __future__ import annotations

import math
import os

import numpy as np
import pytest

from perfbench import frames, harness
from perfbench.glb import write_glb
from perfbench.reference import pathtracer as ref_pt
from perfbench.reference import render as ref_render
from perfbench.reference import world as ref_world
from perfbench.scenes import courtyard, textured_sphere
from perfbench.tests.tiny import cpu_environment, tiny_cell


@pytest.mark.parametrize("workload", ["helmet.pt_still", "courtyard.pt_still"])
def test_reference_matches_port_bit_for_bit(monkeypatch, tmp_path, workload):
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import settings as S
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    cpu_environment(monkeypatch)
    cell = tiny_cell(workload, 40, 24)
    cfg = cell.config
    scene, sky = harness.make_inputs(cell)
    r = Renderer(S.RenderSettings(backend="pathtracer", width=40, height=24,
                                  pt=S.PathTracerSettings(**cfg["pt"])), device="cpu")
    r.load_scene(write_glb(os.path.join(tmp_path, "s.glb"), scene))
    r.load_environment(sky)
    w2v = ref_pt.look_at(cfg["camera"]["eye"], cfg["camera"]["target"])
    r.camera.world_to_view = w2v
    r.camera.y_fov = math.radians(cfg["camera"]["y_fov_deg"])
    r.camera.z_near = cfg["camera"]["z_near"]
    traffic = frames.Traffic(cell.traffic, 2 ** 32 + 5)
    seeds = [traffic.frame_seed(i) for i in range(3)]
    hops = pt.ALPHA_RETRY_HOPS
    for s in seeds:
        img = r.draw_frame(seed=s)
    yy, xx = np.meshgrid(np.arange(24), np.arange(40), indexing="ij")
    px, py = xx.ravel(), yy.ravel()
    c2w = ref_pt.clip_to_world(w2v, math.radians(cfg["camera"]["y_fov_deg"]), 40 / 24,
                               cfg["camera"]["z_near"])
    assert np.array_equal(c2w, r.camera.clip_to_world())
    ref = ref_render.build_scene(scene, sky, "cpu")
    acc = ref_render.accumulate(ref, ref_pt.Settings(), c2w, (40, 24), px, py, seeds)
    u8 = ref_render.frame_u8(acc, px, py, r.frame_index - 1).numpy()
    np.testing.assert_array_equal(acc.numpy().reshape(24, 40, 3), r._accum.numpy())
    np.testing.assert_array_equal(u8.reshape(24, 40, 3), img)
    if workload.startswith("courtyard"):
        assert ref.has_masked and pt.ALPHA_RETRY_HOPS > hops  # the masked retry ran


def test_frozen_generators_match_the_programs():
    """The geometry is the program's; the maps are the assets' set in kind,
    count and size (courtyard: 25 materials x base colour, normal and
    metallic-roughness; sphere: five maps on one material)."""
    from gltf_renderer_tpu_torch.scene import procedural

    mine = courtyard.build(density=1, tex_size=16)
    theirs = procedural.courtyard_scene(density=1, tex_size=16)
    assert sum(len(p["idx"]) // 3 for p in mine["prims"]) == 273_856
    assert len(theirs.pools.tri_vertex) == 273_856
    np.testing.assert_array_equal(np.concatenate([p["pos"] for p in mine["prims"]]),
                                  theirs.pools.positions)
    assert len(mine["materials"]) == 25 and len(mine["textures"]) == 75
    assert all(m["normal"] >= 0 and m["mr"] >= 0 and m["albedo"] >= 0 for m in mine["materials"])
    assert sum("mask_cutoff" in m for m in mine["materials"]) == 6
    mine = textured_sphere.build(tex_size=16, n_lat=128, n_lon=192)
    theirs = procedural.textured_sphere_scene(tex_size=16, n_lat=128, n_lon=192)
    assert len(mine["prims"][0]["idx"]) // 3 == len(theirs.pools.tri_vertex) == 48_768
    np.testing.assert_array_equal(mine["prims"][0]["pos"], theirs.pools.positions)
    m = mine["materials"][0]
    assert sorted(m[k] for k in ("albedo", "normal", "mr", "occlusion", "emissive")) == list(range(5))
    assert [t["image"].shape for t in mine["textures"]] == [(16, 16, 4)] * 5


def test_glb_reads_back_through_the_programs_loader(tmp_path):
    from gltf_renderer_tpu_torch.scene import types as T
    from gltf_renderer_tpu_torch.scene.gltf import load_gltf

    scene = courtyard.build(density=1, tex_size=16)
    loaded = load_gltf(write_glb(os.path.join(tmp_path, "c.glb"), scene))
    pos = np.concatenate([p["pos"] for p in scene["prims"]])
    nrm = np.concatenate([ref_world.quantize_normals(p["normal"])[0] for p in scene["prims"]])
    np.testing.assert_array_equal(loaded.pools.positions, pos)
    np.testing.assert_array_equal(loaded.pools.normals, nrm)
    assert list(loaded.materials.alpha_mode[1:]) == [0] * 19 + [1] * 6
    assert len(loaded.textures.x) == 75
    sphere = textured_sphere.build(tex_size=16)
    loaded = load_gltf(write_glb(os.path.join(tmp_path, "s.glb"), sphere))
    slots = (T.TEX_ALBEDO, T.TEX_NORMAL, T.TEX_METALLIC_ROUGHNESS, T.TEX_OCCLUSION, T.TEX_EMISSIVE)
    assert all(loaded.materials.tex_index[1, s] >= 0 for s in slots)
    assert list(loaded.textures.srgb) == [1, 0, 0, 0, 1]
