"""The port's sample x tile sharding (gltf_renderer_tpu_torch/parallel/)
in one process, on the CPU: the cases of tests/test_sharding.py, with the
8 emulated JAX devices replaced by meshes of 8 cells that one rank draws
in turn (no process group: the gathers are local).

- 1 x 8 tiles of the box at 32x32 against the port's unsharded frame, and
  one tile against the JAX package's `pt.trace` of that tile through its
  own pixel_offset / full_resolution;
- the non-divisible height 32x36 (tile_h 5, four rows cropped), shape
  (36, 32, 3);
- the raster frame 1 x 8 on the blended material zoo under an environment,
  through `lit_gather` (the backdrop pyramid built from the whole image);
- the 4 x 2 sample mean against the mean of four unsharded seeds;
- `initialize()` without a group, and `replicate`;
- the cell and raster-region maps of meshes split over several ranks.

Tolerances are test_sharding.py's, 2e-5 (1e-4 for the sample mean); the
bits are expected equal and were (largest difference 0 on every case but
the JAX tile, 2.4e-7 there: XLA's fused multiply-adds).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.render import pathtracer as jpt
from gltf_renderer_tpu.render import settings as JS
from gltf_renderer_tpu.scene.gltf import load_gltf as jax_load_gltf
from gltf_renderer_tpu_torch import camera
from gltf_renderer_tpu_torch.bench_scene import world_from_scene
from gltf_renderer_tpu_torch.env.environment import build_environment
from gltf_renderer_tpu_torch.parallel import distributed, sharding
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.render import rasterizer
from gltf_renderer_tpu_torch.render import settings as PS
from gltf_renderer_tpu_torch.scene.gltf import load_gltf
from tests.scenes import write_box_gltf, write_materials_gltf
from tests.test_env import _test_equirect
from tests.test_torch_alpha import both

torch.set_num_threads(2)
ATOL = 2e-5


def _c2w(eye, aspect):
    return camera.clip_to_world(camera.look_at(eye, [0.0, 0.0, 0.0]), y_fov=np.pi / 3,
                                aspect=aspect, z_near=0.01)


def _pt_settings(pkg):
    return pkg.PathTracerSettings(max_bounces=1, min_bounces=1, environment_map=False)


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    path = write_box_gltf(str(tmp_path_factory.mktemp("box") / "box.gltf"))
    return dict(both(jax_load_gltf(path)), c2w=_c2w([2.0, -2.0, 1.5], 1.0))


def _single(box, res, seed):
    return ppt.trace(box["pscene"], box["pmeta"], _pt_settings(PS), PS.PathTracerParams(),
                     box["c2w"], res, seed)


def _sharded(box, res, seed, mesh):
    return sharding.render_sharded(box["pscene"], box["pmeta"], _pt_settings(PS),
                                   PS.PathTracerParams(), box["c2w"], res, seed, mesh)


def test_tile_sharded_matches_single(box):
    mesh = sharding.make_mesh(n_sample=1, n_tile=8, device="cpu")
    assert mesh.shape == {"sample": 1, "tile": 8} and len(mesh.cells()) == 8
    shard = _sharded(box, (32, 32), 3, mesh).numpy()
    np.testing.assert_allclose(shard, _single(box, (32, 32), 3).numpy(), rtol=0, atol=ATOL)

    # One tile (rows 12..15) against the JAX package's own tile trace.
    trace = jax.jit(jpt.trace, static_argnums=(1, 2, 5),
                    static_argnames=("pixel_offset", "full_resolution"))
    want = np.asarray(trace(box["jscene"], box["jmeta"], _pt_settings(JS), JS.PathTracerParams(),
                            jnp.asarray(box["c2w"]), (32, 4), jnp.uint32(3),
                            pixel_offset=(0, 12), full_resolution=(32, 32)))
    tile = ppt.trace(box["pscene"], box["pmeta"], _pt_settings(PS), PS.PathTracerParams(),
                     box["c2w"], (32, 4), 3, pixel_offset=(0, 12), full_resolution=(32, 32))
    np.testing.assert_allclose(tile.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tile.numpy(), shard[12:16])


def test_tile_sharded_nondivisible_height(box):
    mesh = sharding.make_mesh(n_sample=1, n_tile=8, device="cpu")
    res = (32, 36)  # tile_h 5: the last tile's four rows past the bottom are cropped
    shard, stats = sharding.render_sharded(box["pscene"], box["pmeta"], _pt_settings(PS),
                                           PS.PathTracerParams(), box["c2w"], res, 3, mesh,
                                           with_stats=True)
    assert shard.shape == (36, 32, 3)
    single, single_stats = ppt.trace(box["pscene"], box["pmeta"], _pt_settings(PS),
                                     PS.PathTracerParams(), box["c2w"], res, 3,
                                     with_stats=True)
    np.testing.assert_allclose(shard.numpy(), single.numpy(), rtol=0, atol=ATOL)
    # The frame's stats count every cell's rays: the cropped rows' too.
    assert float(stats[0]) > float(single_stats[0]) and float(stats[1]) == 0.0


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    src = load_gltf(write_materials_gltf(str(tmp_path_factory.mktemp("zoo") / "zoo.gltf")))
    world, lights = world_from_scene(src)
    env = build_environment(_test_equirect(16, 32), cube_size=16, device="cpu", diffuse_size=8)
    scene, meta = ppt.make_pt_scene(world, src.materials, src.textures, lights, env=env,
                                    device="cpu")
    assert meta.has_blend, "the zoo must exercise the backdrop gather"
    return scene, meta


def test_raster_sharded_matches_single(zoo, monkeypatch):
    scene, meta = zoo
    eye = [0.0, -6.0, 2.0]
    res = (32, 36)
    c2w = _c2w(eye, 1.0)
    cam_pos = np.asarray(eye, np.float32)
    args = (scene, meta, PS.RenderSettings(), PS.PathTracerParams(), c2w, cam_pos, res, 0)
    single = rasterizer.render(*args)
    backdrops = []
    build = rasterizer.build_transmission_mips
    monkeypatch.setattr(rasterizer, "build_transmission_mips",
                        lambda lit, *a, **k: backdrops.append(lit.shape) or build(lit, *a, **k))
    mesh = sharding.make_mesh(n_sample=1, n_tile=8, device="cpu")
    shard = sharding.render_raster_sharded(*args, mesh)
    assert shard.shape == single.shape == (36, 32, 3)
    assert backdrops == [(36, 32, 3)]  # the gathered image, not the (40, 32) region
    np.testing.assert_allclose(shard.numpy(), single.numpy(), rtol=0, atol=ATOL)

    lit, mv = sharding.render_raster_sharded(*args, mesh, with_motion=True)
    want_lit, want_mv = rasterizer.render(*args, with_motion=True)
    np.testing.assert_allclose(lit.numpy(), want_lit.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(mv.numpy(), want_mv.numpy(), rtol=0, atol=ATOL)


def test_distributed_single_process_and_replicate(box):
    assert distributed.initialize(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    mesh = sharding.make_mesh(n_sample=1, n_tile=8, device="cpu")
    scene = box["pscene"]
    host = scene._replace(world=ppt._to_host(scene.world), wide_nodes=scene.wide_nodes.numpy())
    scene_g = distributed.replicate(host, mesh)
    assert isinstance(scene_g.wide_nodes, torch.Tensor)
    assert isinstance(scene_g.world.position, torch.Tensor)
    assert scene_g.bvh is box["pscene"].bvh and scene_g.packed is box["pscene"].packed
    shard = sharding.render_sharded(scene_g, box["pmeta"], _pt_settings(PS),
                                    PS.PathTracerParams(), box["c2w"], (32, 32), 3, mesh)
    np.testing.assert_allclose(shard.numpy(), _single(box, (32, 32), 3).numpy(), rtol=0,
                               atol=ATOL)


def test_sample_sharded_mean(box):
    mesh = sharding.make_mesh(n_sample=4, n_tile=2, device="cpu")
    shard = _sharded(box, (32, 32), 11, mesh).numpy()
    singles = [_single(box, (32, 32), (11 + k * 0x9E3779B9) & 0xFFFFFFFF).numpy()
               for k in range(4)]
    np.testing.assert_allclose(shard, np.mean(singles, 0), rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape, world, cells, regions", [
    ((1, 8), 4, [[(0, 0), (0, 1)], [(0, 2), (0, 3)], [(0, 4), (0, 5)], [(0, 6), (0, 7)]],
     [(0, 2), (2, 2), (4, 2), (6, 2)]),
    ((2, 2), 4, [[(0, 0)], [(0, 1)], [(1, 0)], [(1, 1)]], [(0, 1), (1, 1), (0, 1), (1, 1)]),
    # A rank whose cells wrap to the next sample draws its tiles' whole span.
    ((2, 3), 3, [[(0, 0), (0, 1)], [(0, 2), (1, 0)], [(1, 1), (1, 2)]],
     [(0, 2), (0, 3), (1, 2)]),
])
def test_mesh_cells_and_raster_regions(shape, world, cells, regions):
    meshes = [sharding.Mesh(*shape, rank=r, world_size=world, device=torch.device("cpu"))
              for r in range(world)]
    assert [m.cells() for m in meshes] == cells
    assert sharding._regions(meshes[0]) == regions
    with pytest.raises(ValueError, match="does not split"):
        sharding.make_mesh(0, 1, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()
