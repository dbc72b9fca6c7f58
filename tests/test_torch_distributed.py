"""The port's sharded frames over real process groups: spawned gloo ranks
on the CPU, joined through a file:// store under the test's tmp_path,
torch.set_num_threads(1) in each rank. Every test starts its ranks, joins
them within RANK_DEADLINE_S, kills the ones still alive and fails if any
was; the ranks write their results to files the test reads.

- 4 ranks, a 2 x 2 mesh (one cell a rank) on the blended material zoo
  under an environment at 32x32: the path-tracer sample (the mean of the
  two sample cells' seeds) and the raster frame, whose backdrop gather
  crosses the ranks, against the unsharded frames drawn in this process;
- 2 ranks: Renderer(mesh="auto") draw_frame on both backends against the
  unsharded renderer, save_state written by rank 0 only, and the CLI with
  --shard auto (rank 0's PNG equal to the single-process CLI's; rank 1
  writes none); then, in the same group, sharded sessions in which one
  rank raises (FAULT_SESSIONS): the CLI with a scene file missing on rank
  1 (the status exchange before the load), one that fails to parse on
  rank 1 (the load's), rank 1's path-traced or raster cells raising, rank
  1's post raising after the frame's last gather, rank 0's save_png
  raising between two frames; and a user's loop of Renderer(mesh="auto")
  calls whose load, cells or post raise on rank 1. In each the raising
  rank fails with its own error (the CLI: rc 1 and "error: failed to load
  ..." for a load), every other rank's CLI returns 1 with "error: rank r:
  <error>" on stderr or its Renderer raises RankFailed naming rank r, and
  the group goes on to the next session: no rank waits in a collective;
- 2 ranks: the viewer with shard="auto": rank 0 serves a frame over
  HTTP, rank 1 follows; a load of a file only rank 0 holds (a path
  relative to each rank's own working directory) is refused with a
  load_error and the next frame still comes, a load of a file both hold
  reaches both ranks; rank 0 stops and both ranks exit. Then two more
  viewer sessions in the same group, in which one rank's draw_frame
  raises on its FAULT_FRAME-th call: rank 1's before drawing (rank 0
  waits in the frame's status exchange), rank 0's after drawing (rank 1
  waits for the next frame's inputs). In both every rank leaves its loop,
  each state.error names the rank that raised, and the frames drawn
  before are the unsharded viewer's.

Tolerance 2e-5, as tests/test_sharding.py; the bits are expected equal
and were (largest difference 0).
"""

import json
import multiprocessing
import os
import pickle
import time
import urllib.request

import numpy as np
import torch

from gltf_renderer_tpu_torch import camera
from gltf_renderer_tpu_torch.bench_scene import analytic_sky, world_from_scene
from gltf_renderer_tpu_torch.env.environment import build_environment
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.render import rasterizer
from gltf_renderer_tpu_torch.render import settings as PS
from gltf_renderer_tpu_torch.scene.procedural import write_box_gltf, write_materials_gltf

torch.set_num_threads(2)
RANK_DEADLINE_S = 120
ATOL = 2e-5
RES = (32, 32)
EYE = [0.0, -6.0, 2.0]
SEED = 7


def _spawn(target, world, tmp_path, *args):
    """Run target(rank, world, tmp_path, *args) in `world` spawned gloo
    ranks; returns each rank's pickled result. Fails (after killing the
    ranks) if one is alive at the deadline or exits non-zero."""
    ctx = multiprocessing.get_context("spawn")
    store = tmp_path / f"store_{target.__name__}"
    procs = [ctx.Process(target=_rank_main, args=(target, r, world, str(store), str(tmp_path),
                                                  args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_DEADLINE_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert not hung, f"ranks {hung} still running after {RANK_DEADLINE_S}s"
    assert [p.exitcode for p in procs] == [0] * world
    return [pickle.loads((tmp_path / f"{target.__name__}_{r}.pkl").read_bytes())
            for r in range(world)]


def _rank_main(target, rank, world, store, out_dir, args):
    from gltf_renderer_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize(backend="gloo", init_method=f"file://{store}", world_size=world,
                           rank=rank, device="cpu")
    try:
        out = target(rank, world, out_dir, *args)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"{target.__name__}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _zoo(path, env):
    """The zoo read from `path` under `env` (built once by the test and
    handed to the ranks: its prefilters take seconds a process)."""
    from gltf_renderer_tpu_torch.scene.gltf import load_gltf

    src = load_gltf(path)
    world, lights = world_from_scene(src)
    return ppt.make_pt_scene(world, src.materials, src.textures, lights, env=env, device="cpu")


def _zoo_args():
    c2w = camera.clip_to_world(camera.look_at(EYE, [0.0, 0.0, 0.0]), y_fov=np.pi / 3,
                               aspect=1.0, z_near=0.01)
    return c2w, np.asarray(EYE, np.float32), PS.PathTracerSettings(max_bounces=1, min_bounces=1)


def _mesh_frames(rank, world, out_dir, path, env):
    """A 2 x 2 mesh, one cell a rank: the path-tracer sample and the raster
    frame of the zoo, each whole on every rank."""
    from gltf_renderer_tpu_torch.parallel import sharding

    scene, meta = _zoo(path, env)
    c2w, cam_pos, pt_settings = _zoo_args()
    mesh = sharding.make_mesh(2, 2, device="cpu")
    pt_img, stats = sharding.render_sharded(scene, meta, pt_settings, PS.PathTracerParams(),
                                            c2w, RES, SEED, mesh, with_stats=True)
    raster = sharding.render_raster_sharded(scene, meta, PS.RenderSettings(),
                                            PS.PathTracerParams(), c2w, cam_pos, RES, 0, mesh)
    return dict(cells=mesh.cells(), pt=pt_img.numpy(), stats=stats.numpy(),
                raster=raster.numpy(), log=[name for name, _, _ in mesh.log])


def test_mesh_2x2_over_four_ranks(tmp_path):
    path = write_materials_gltf(str(tmp_path / "zoo.gltf"))
    env = build_environment(analytic_sky(16, 32), cube_size=16, device="cpu", diffuse_size=8)
    got = _spawn(_mesh_frames, 4, tmp_path, path, env)
    scene, meta = _zoo(path, env)
    c2w, cam_pos, pt_settings = _zoo_args()
    samples = [ppt.trace(scene, meta, pt_settings, PS.PathTracerParams(), c2w, RES,
                         (SEED + s * ppt.SEED_STRIDE) & 0xFFFFFFFF, with_stats=True)
               for s in range(2)]
    want_pt = ((samples[0][0] + samples[1][0]) / 2).numpy()
    want_stats = (samples[0][1] + samples[1][1]).numpy()
    want_raster = rasterizer.render(scene, meta, PS.RenderSettings(), PS.PathTracerParams(),
                                    c2w, cam_pos, RES, 0).numpy()
    assert [g["cells"] for g in got] == [[(0, 0)], [(0, 1)], [(1, 0)], [(1, 1)]]
    for g in got:
        np.testing.assert_allclose(g["pt"], want_pt, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(g["stats"], want_stats)
        np.testing.assert_allclose(g["raster"], want_raster, rtol=0, atol=ATOL)
        assert g["log"] == ["path_tracer", "raster_lit", "raster"]


def _renderer_and_cli(rank, world, out_dir, box, single_png):
    """Renderer(mesh="auto") frames and checkpoint, then the CLI with
    --shard auto, then the fault sessions, on this rank."""
    from gltf_renderer_tpu_torch.app import cli
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    frames = {}
    for backend in ("pathtracer", "rasterizer"):
        r = Renderer(PS.RenderSettings(backend=backend, width=32, height=24,
                                       pt=PS.PathTracerSettings(max_bounces=1, min_bounces=1)),
                     mesh="auto", device="cpu")
        r.load_scene(box)
        r.camera.aspect_ratio = 32 / 24
        r.camera.world_to_view = camera.look_at([2.0, -2.0, 1.5], [0.0, 0.0, 0.0])
        frames[backend] = [r.draw_frame() for _ in range(2)]
        frames[backend + "_accum"] = r._accum.numpy()
    r.save_state(os.path.join(out_dir, f"state_{rank}.npz"))
    rc = cli.main(_cli_argv(box, os.path.join(out_dir, f"cli_{rank}.png")) + ["--shard", "auto"],
                  device="cpu")
    return dict(frames=frames, mesh=(r.mesh.rank, r.mesh.world_size, r.mesh.cells()), rc=rc,
                faults=_fault_sessions(rank, out_dir, box))


FAULT = "RuntimeError: injected fault"
# session: (raising rank, what raises); "cli_*" sessions run the CLI with
# --shard auto, "loop_*" a user's loop of sharded Renderer calls.
FAULT_SESSIONS = {
    "cli_load_missing": (1, "the scene file is missing on rank 1"),
    "cli_load_parse": (1, "the scene file does not parse on rank 1"),
    "cli_cells_pt": (1, "pathtracer.trace"),
    "cli_cells_raster": (1, "rasterizer.render"),
    "cli_post": (1, "renderer.post_step"),
    "cli_save_png": (0, "cli.save_png"),
    "loop_load": (1, "the scene file does not parse on rank 1"),
    "loop_cells": (1, "pathtracer.trace"),
    "loop_post": (1, "renderer.post_step"),
}
LOOP_FRAMES = 3


def _injected(module, name, rank, raiser, at_call):
    """Patch module.name to raise RuntimeError("injected fault") on rank
    `raiser`'s `at_call`-th call; returns the undo."""
    real = getattr(module, name)
    calls = [0]

    def call(*a, **kw):
        calls[0] += 1
        if rank == raiser and calls[0] == at_call:
            raise RuntimeError("injected fault")
        return real(*a, **kw)

    setattr(module, name, call)
    return lambda: setattr(module, name, real)


def _fault_sessions(rank, out_dir, box):
    """Each FAULT_SESSIONS session on this rank, in this process group.
    Returns {session: (rc or the raised error, stderr, frames drawn)}."""
    import contextlib
    import io

    from gltf_renderer_tpu_torch.app import cli
    from gltf_renderer_tpu_torch.parallel.distributed import RankFailed
    from gltf_renderer_tpu_torch.render import pathtracer, rasterizer
    from gltf_renderer_tpu_torch.render import renderer as renderer_mod
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    cwd = os.path.join(out_dir, f"faults{rank}")
    os.makedirs(cwd)
    os.chdir(cwd)  # relative paths name each rank's own files
    if rank == 0:
        write_box_gltf("only_rank0.gltf")
        write_box_gltf("bad.gltf")
    else:
        with open("bad.gltf", "w") as f:
            f.write("not a glTF document")
    targets = {"pathtracer.trace": (pathtracer, "trace"),
               "rasterizer.render": (rasterizer, "render"),
               "renderer.post_step": (renderer_mod, "post_step"),
               "cli.save_png": (cli, "save_png")}
    out = {}
    for session, (raiser, what) in FAULT_SESSIONS.items():
        scene = {"cli_load_missing": "only_rank0.gltf", "cli_load_parse": "bad.gltf",
                 "loop_load": "bad.gltf"}.get(session, box)
        # The loop's cells raise in its second frame, its post in its last.
        at_call = LOOP_FRAMES if session == "loop_post" else 2 if session == "loop_cells" else 1
        undo = (_injected(*targets[what], rank, raiser, at_call) if what in targets
                else lambda: None)
        err, frames = io.StringIO(), []
        try:
            with contextlib.redirect_stderr(err):
                if session.startswith("cli_"):
                    argv = _cli_argv(scene, f"{session}.png") + ["--shard", "auto"]
                    if session == "cli_cells_raster":
                        argv += ["--backend", "rasterizer"]
                    if session == "cli_save_png":
                        argv += ["--frames", "2"]
                    result = cli.main(argv, device="cpu")
                else:
                    r = Renderer(PS.RenderSettings(width=32, height=24, pt=PS.PathTracerSettings(
                        max_bounces=1, min_bounces=1)), mesh="auto", device="cpu")
                    r.load_scene(scene)
                    for _ in range(LOOP_FRAMES):
                        frames.append(r.draw_frame())
                    result = 0
        except (RankFailed, RuntimeError, ValueError) as e:
            result = f"{type(e).__name__}: {e}"
        finally:
            undo()
        out[session] = (result, err.getvalue(), len(frames))
    return out


def _cli_argv(box, out):
    return ["--gltf", box, "--width", "32", "--height", "24", "--spp", "2", "--max-bounces",
            "1", "--min-bounces", "1", "--output", out]


def test_renderer_and_cli_over_two_ranks(tmp_path):
    from PIL import Image

    from gltf_renderer_tpu_torch.app import cli
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    box = write_box_gltf(str(tmp_path / "box.gltf"))
    single_png = str(tmp_path / "cli_single.png")
    assert cli.main(_cli_argv(box, single_png), device="cpu") == 0
    got = _spawn(_renderer_and_cli, 2, tmp_path, box, single_png)
    assert [g["mesh"] for g in got] == [(0, 2, [(0, 0)]), (1, 2, [(0, 1)])]
    for backend in ("pathtracer", "rasterizer"):
        r = Renderer(PS.RenderSettings(backend=backend, width=32, height=24,
                                       pt=PS.PathTracerSettings(max_bounces=1, min_bounces=1)),
                     device="cpu")
        r.load_scene(box)
        r.camera.aspect_ratio = 32 / 24
        r.camera.world_to_view = camera.look_at([2.0, -2.0, 1.5], [0.0, 0.0, 0.0])
        want = [r.draw_frame() for _ in range(2)]
        for g in got:
            for a, b in zip(g["frames"][backend], want):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(g["frames"][backend + "_accum"], r._accum.numpy(),
                                       rtol=0, atol=ATOL)
    assert (tmp_path / "state_0.npz").exists() and not (tmp_path / "state_1.npz").exists()
    assert [g["rc"] for g in got] == [0, 0]
    assert not (tmp_path / "cli_1.png").exists()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "cli_0.png")),
                                  np.asarray(Image.open(single_png)))

    for session, (raiser, what) in FAULT_SESSIONS.items():
        own, other = got[raiser]["faults"][session], got[1 - raiser]["faults"][session]
        cause = {"cli_load_missing": "FileNotFoundError: no such file",
                 "cli_load_parse": "JSONDecodeError: ",
                 "loop_load": "JSONDecodeError: "}.get(session, FAULT)
        if session.startswith("cli_load"):
            assert own[0] == 1 and own[1].startswith("error: failed to load "), (session, own)
        else:
            assert own[0].startswith(cause), (session, what, own)
        if session.startswith("cli_"):
            assert other[0] == 1, (session, other)
            assert other[1].startswith(f"error: rank {raiser}: {cause}"), (session, other)
        else:
            assert other[0] == f"RankFailed: rank {raiser}: {own[0]}", (session, other)
    # The loop's frames before the fault: none after a failed load, one
    # before its second frame's cells, two before its last frame's post.
    assert [[g["faults"][s][2] for g in got] for s in ("loop_load", "loop_cells", "loop_post")] \
        == [[0, 0], [1, 1], [LOOP_FRAMES - 1, LOOP_FRAMES - 1]]
    assert not (tmp_path / "faults1" / "cli_save_png_0000.png").exists()


def _viewer(rank, world, out_dir, box, box2):
    """Rank 0 serves and reads a frame over HTTP, posts a load of a file
    only it holds (refused) and one of a file both hold, then stops; rank 1
    follows until the stop."""
    from gltf_renderer_tpu_torch.app import viewer

    cwd = os.path.join(out_dir, f"cwd{rank}")
    os.makedirs(cwd)
    os.chdir(cwd)
    if rank == 0:
        write_box_gltf("only_rank0.gltf")
    server, state, thread = viewer.serve(box, width=32, height=24, port=0, block=False,
                                         shard="auto", device="cpu", host="127.0.0.1")
    out = {}
    if rank == 0:
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def wait(cond):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                st = json.loads(urllib.request.urlopen(base + "/state", timeout=10).read())
                if cond(st) or st["error"]:
                    return st
                time.sleep(0.05)
            return st

        def post(ev):
            urllib.request.urlopen(urllib.request.Request(
                base + "/input", data=json.dumps(ev).encode(), method="POST"), timeout=10)

        st = wait(lambda st: st["frame"] > 0)
        out["png"] = urllib.request.urlopen(base + "/frame.png", timeout=10).read()
        post({"type": "load", "path": "only_rank0.gltf"})
        st = wait(lambda st: st["load_error"])
        out["load_error"], seq = st["load_error"], st["frame"]
        post({"type": "orbit", "dx": 40, "dy": 0})
        out["after_refusal"] = wait(lambda st: st["frame"] > seq)["frame"] > seq
        post({"type": "load", "path": box2})
        st = wait(lambda st: st["scene"] == box2)
        seq = st["frame"]
        wait(lambda st: st["frame"] > seq)  # a frame drawn on box2 by both ranks
        state.running = False
        server.shutdown()
        server.server_close()
    thread.join(timeout=60)
    out.update(alive=thread.is_alive(), error=state.error, spp=state.spp,
               scene=state.scene_path)
    out["faults"] = {raiser: _viewer_fault(rank, box, raiser) for raiser in (1, 0)}
    return out


FAULT_FRAME = 3
FAULT = "RuntimeError: injected fault"


def _viewer_fault(rank, box, raiser):
    """A sharded viewer session on `box` in which rank `raiser`'s
    draw_frame raises on its FAULT_FRAME-th call (rank 1 before drawing,
    rank 0 after); returns whether the loop thread still runs, state.error
    and the frames this rank drew."""
    from gltf_renderer_tpu_torch.app import viewer
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    frames = []
    draw = Renderer.draw_frame

    def draw_or_raise(self, *a, **kw):
        if rank == raiser == 1 and len(frames) == FAULT_FRAME - 1:
            raise RuntimeError("injected fault")
        frames.append(draw(self, *a, **kw))
        if rank == raiser == 0 and len(frames) == FAULT_FRAME:
            raise RuntimeError("injected fault")
        return frames[-1]

    Renderer.draw_frame = draw_or_raise
    try:
        server, state, thread = viewer.serve(box, width=32, height=24, port=0, block=False,
                                             shard="auto", device="cpu", host="127.0.0.1")
        thread.join(timeout=60)
    finally:
        Renderer.draw_frame = draw
    if server is not None:
        server.shutdown()
        server.server_close()
    return dict(alive=thread.is_alive(), error=state.error, running=state.running,
                frames=frames)


def _unsharded_viewer_frames(box, n):
    """The first n frames of `box` at 32x24 from viewer.serve's camera,
    unsharded."""
    from gltf_renderer_tpu_torch.app.cli import scene_bounds
    from gltf_renderer_tpu_torch.camera import OrbitController
    from gltf_renderer_tpu_torch.render.renderer import Renderer

    r = Renderer(PS.RenderSettings(width=32, height=24), device="cpu")
    centre, radius = scene_bounds(r.load_scene(box))
    r.camera.aspect_ratio = 32 / 24
    r.camera.z_near = max(1e-3, 0.01 * radius)
    r.camera.world_to_view = OrbitController(centre=centre, radius=2.5 * radius).world_to_view()
    return [r.draw_frame() for _ in range(n)]


def test_viewer_follows_over_two_ranks(tmp_path):
    box = write_box_gltf(str(tmp_path / "box.gltf"))
    box2 = write_box_gltf(str(tmp_path / "box2.gltf"))
    got = _spawn(_viewer, 2, tmp_path, box, box2)
    assert [(g["alive"], g["error"]) for g in got] == [(False, None), (False, None)]
    assert got[0]["png"][:8] == b"\x89PNG\r\n\x1a\n"
    assert got[0]["spp"] >= 1 and got[1]["spp"] >= 1
    assert got[0]["load_error"] == "load refused: only_rank0.gltf is missing on ranks [1]"
    assert got[0]["after_refusal"]
    assert [g["scene"] for g in got] == [box2, box2]

    want = _unsharded_viewer_frames(box, FAULT_FRAME)
    for raiser in (1, 0):
        faults = [g["faults"][raiser] for g in got]
        assert [(f["alive"], f["running"]) for f in faults] == [(False, False)] * 2
        assert [f["error"] for f in faults] == [f"RankFailed: rank {raiser}: {FAULT}"] * 2
        drawn = FAULT_FRAME - 1 if raiser == 1 else FAULT_FRAME
        for f in faults:
            assert len(f["frames"]) == drawn
            for a, b in zip(f["frames"], want):
                np.testing.assert_array_equal(a, b)
