"""Environment IO and the two disk caches of the port against the JAX package.

Tolerance: none. `.hdr` and `.exr` files written by either package are read
by both to the same float32 bits, for every EXR compression (none, RLE,
ZIPS, ZIP, PIZ, PXR24) x half / float x scanline / tiled. The images are
at most 64x32, since the PIZ writer is pure-Python Huffman coding. The
native PIZ decoder (native/exr_piz.cpp, built by env/piz.py) decodes
byte-identically to the Python one. The environment cache and the scene
cache return tensors bit-identical to a fresh build.
"""

import os

import numpy as np
import pytest
import torch

from gltf_renderer_tpu.env import hdr_io as jax_io
from gltf_renderer_tpu.env import piz as jax_piz
from gltf_renderer_tpu_torch.bench_scene import analytic_equirect, analytic_sky, world_from_scene
from gltf_renderer_tpu_torch.env import environment as env_ops
from gltf_renderer_tpu_torch.env import hdr_io, piz
from gltf_renderer_tpu_torch.render import pathtracer as pt
from gltf_renderer_tpu_torch.scene.procedural import foliage_scene
from gltf_renderer_tpu_torch.utils import scene_cache

COMPRESSIONS = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4, "pxr24": 5}


def _image():
    """64x32 of the bench sky: smooth enough that the codecs compress its
    blocks (a block that does not shrink is stored raw, decoded by none)."""
    return analytic_sky(32, 64)


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("layout", ["scanline", "tiled"])
@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
@pytest.mark.parametrize("comp", sorted(COMPRESSIONS), ids=sorted(COMPRESSIONS))
def test_exr_read_by_both_packages(comp, half, layout, tmp_path):
    """Files from either writer read to the same bits by both readers, and
    hold the source (halves exact, PXR24 floats truncated to 24 bits)."""
    img = _image()
    tile = (32, 32) if layout == "tiled" else None
    want = img.astype(np.float16).astype(np.float32) if half else img
    if comp == "pxr24" and not half:
        want = (want.view(np.uint32) >> 8 << 8).view(np.float32)
    for writer in (hdr_io, jax_io):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.exr")
        writer.write_exr(path, img, compression=COMPRESSIONS[comp], half=half, tile=tile)
        decodes = piz.NATIVE_DECODES
        got = hdr_io.read_exr(path)
        assert (piz.NATIVE_DECODES > decodes) == (comp == "piz")
        _same_bits(got, jax_io.read_exr(path))
        _same_bits(got, want)
    with open(path, "rb") as f:  # the JAX writer's file
        assert f.read() == open(str(tmp_path / "gltf_renderer_tpu_torch.exr"), "rb").read()


def test_hdr_read_by_both_packages(tmp_path):
    img = _image()
    for writer in (hdr_io, jax_io):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.hdr")
        writer.write_hdr(path, img)
        got = hdr_io.read_hdr(path)
        _same_bits(got, jax_io.read_hdr(path))
        # RGBE keeps 8 mantissa bits of each pixel's largest channel.
        assert np.abs(got - img).max() <= 2.0 ** -8 * img.max()


def test_read_environment_image_dispatch(tmp_path):
    """.hdr, .exr (RGB and one Y channel, repeated to RGB) and a refusal."""
    img = _image()
    paths = {"a.hdr": lambda p: hdr_io.write_hdr(p, img),
             "b.exr": lambda p: hdr_io.write_exr(p, img, compression=3),
             "c.exr": lambda p: hdr_io.write_exr(p, img[..., 0], compression=2)}
    for name, write in paths.items():
        p = str(tmp_path / name)
        write(p)
        got = hdr_io.read_environment_image(p)
        assert got.shape == (32, 64, 3)
        _same_bits(got, jax_io.read_environment_image(p))
    with pytest.raises(ValueError):
        hdr_io.read_environment_image(str(tmp_path / "d.png"))


def test_piz_native_matches_python():
    """native/exr_piz.cpp decodes byte-identically to the Python decoder on
    half, float and wide-value-range blocks (the latter >= 2^14 distinct
    values in one block: the 16-bit wavelet), as tests/test_env.py holds
    the JAX package's; the blocks come from both packages' encoders."""
    rs = np.random.RandomState(7)
    cases = []
    h16 = rs.uniform(0, 4, (24, 20, 3)).astype(np.float16)
    cases.append(([("B", 1), ("G", 1), ("R", 1)], h16.view(np.uint16), 20, 24))
    f32 = rs.uniform(0, 4, (12, 20, 3)).astype(np.float32)
    cases.append(([("B", 2), ("G", 2), ("R", 2)], f32.view(np.uint16), 20, 12))
    bits = np.arange(0x7C00, dtype=np.uint16)
    rs.shuffle(bits)
    wide = bits[: 32 * 200 * 3].reshape(32, 200, 3)
    assert len(np.unique(wide)) >= (1 << 14)
    cases.append(([("B", 1), ("G", 1), ("R", 1)], wide, 200, 32))
    for channels, arr, w, n_lines in cases:
        raw = arr.reshape(n_lines, -1).tobytes()
        for blob in (piz.piz_compress(raw, channels, w, n_lines),
                     jax_piz.piz_compress(raw, channels, w, n_lines)):
            assert piz.piz_uncompress(blob, channels, w, n_lines, allow_native=False) == raw
            assert piz.piz_uncompress(blob, channels, w, n_lines) == raw


def test_corrupt_piz_block_raises():
    """A block the native decoder rejects raises; no Python decode instead."""
    raw = _image().astype(np.float16)[:8].tobytes()
    blob = piz.piz_compress(raw, [("B", 1), ("G", 1), ("R", 1)], 64, 8)
    with pytest.raises(ValueError, match="corrupt PIZ block"):
        piz.piz_uncompress(blob[:20], [("B", 1), ("G", 1), ("R", 1)], 64, 8)


def _env_fields_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        xs, ys = (x, y) if isinstance(x, list) else ([x], [y])
        assert len(xs) == len(ys), f
        for u, v in zip(xs, ys):
            assert u.device == v.device and u.dtype == v.dtype and u.shape == v.shape, f
            assert u.numpy().tobytes() == v.numpy().tobytes(), f


@pytest.mark.parametrize("prefilters", [True, False], ids=["prefilters", "pt_only"])
def test_environment_cache_round_trip(prefilters, tmp_path):
    """build_environment: a fresh build equals build_environment_pt, and a
    second call reads the cache to the same bits; other sizes miss."""
    eq = analytic_equirect()
    kw = dict(cube_size=16, device="cpu", diffuse_size=8, prefilters=prefilters)
    root = str(tmp_path / "cache")
    fresh = env_ops.build_environment(eq, cache_dir=root, **kw)
    entries = os.listdir(os.path.join(root, "env"))
    assert len(entries) == 1
    _env_fields_equal(fresh, env_ops.build_environment_pt(eq, 16, "cpu", 8, prefilters))
    _env_fields_equal(env_ops.build_environment(eq, cache_dir=root, **kw), fresh)
    if not prefilters:
        env_ops.build_environment(eq, cache_dir=root, **dict(kw, cube_size=32))
        env_ops.build_environment(eq, cache_dir=root, **dict(kw, prefilters=True,
                                                             diffuse_size=4))
        assert len(os.listdir(os.path.join(root, "env"))) == 3


def test_environment_cache_rebuilds_a_torn_entry(tmp_path):
    eq = analytic_equirect()
    root = str(tmp_path)
    env_ops.build_environment(eq, 16, "cpu", root, prefilters=False)
    (entry,) = os.listdir(os.path.join(root, "env"))
    with open(os.path.join(root, "env", entry), "wb") as f:
        f.write(b"torn")
    _env_fields_equal(env_ops.build_environment(eq, 16, "cpu", root, prefilters=False),
                      env_ops.build_environment_pt(eq, 16, "cpu", prefilters=False))


def test_scene_cache_round_trip(tmp_path):
    """make_pt_scene(cache_dir): the second build reads the host tables from
    the cache and places bit-identical tensors; the key is content-addressed."""
    scene = foliage_scene(tex_size=16)
    world, lights = world_from_scene(scene)
    root = str(tmp_path)
    a, meta_a = pt.make_pt_scene(world, scene.materials, scene.textures, lights, device="cpu",
                                 cache_dir=root)
    assert len(os.listdir(scene_cache.cache_dir(root))) == 1
    b, meta_b = pt.make_pt_scene(world, scene.materials, scene.textures, lights, device="cpu",
                                 cache_dir=root)
    c, _ = pt.make_pt_scene(world, scene.materials, scene.textures, lights, device="cpu")
    assert meta_a == meta_b
    for x, y, z in ((a.wide_nodes, b.wide_nodes, c.wide_nodes),
                    (a.leaf_records, b.leaf_records, c.leaf_records),
                    (a.leaf_words, b.leaf_words, c.leaf_words),
                    (a.materials.rows, b.materials.rows, c.materials.rows),
                    (a.textures.mip_flat, b.textures.mip_flat, c.textures.mip_flat),
                    (a.world.tri_attr_rows, b.world.tri_attr_rows, c.world.tri_attr_rows)):
        assert x.numpy().tobytes() == y.numpy().tobytes() == z.numpy().tobytes()
    moved = world._replace(position=world.position + np.float32(1.0))
    assert scene_cache.compute_key((moved, 1)) != scene_cache.compute_key((world, 1))
    assert scene_cache.compute_key((world, 1)) == scene_cache.compute_key(
        (world._replace(position=torch.as_tensor(world.position)), 1))
    assert scene_cache.load("no-such-key", scene_cache.cache_dir(root)) is None
    assert scene_cache.load("k", None) is None
