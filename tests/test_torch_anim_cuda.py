"""The animated path's device work on the card: the BVH refit, the traversal
kernel on refitted tables, and the native PIZ decoder's build.

Imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_anim_cuda.py -q

Without a CUDA device every test here skips. Tolerance: none. The refit
is min / max (exact) and pack_update gathers, so the card's tables equal
the CPU's bit for bit (boxes by `==`: only a zero's sign may differ); the
kernel equals its plain version on them, t, u, v and word.
"""

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch import bench_scene
from gltf_renderer_tpu_torch.ops import bvh
from gltf_renderer_tpu_torch.ops import traverse as tr
from gltf_renderer_tpu_torch.render import pathtracer as pt
from gltf_renderer_tpu_torch.render import rasterizer as rz

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the refit path runs on the card)")
    return torch.device("cuda:0")


def _boxes_equal(a, b):
    a, b = a.cpu(), b.cpu()
    assert not torch.isnan(a).any() and not torch.isnan(b).any()
    assert a.shape == b.shape and bool((a == b).all())


@pytest.mark.parametrize("n", [5, 3000, 60000])
def test_device_refit_is_the_cpu_refit(n, cuda_device):
    rs = np.random.RandomState(n)
    c = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    p = [c + rs.uniform(-0.1, 0.1, (n, 3)).astype(np.float32) for _ in range(3)]
    tree = bvh.build(*p)
    order = tree.tri_order
    packed = bvh.pack(tree, p[0][order], (p[1] - p[0])[order], (p[2] - p[0])[order],
                      order.astype(np.int32))
    q = [torch.as_tensor(x + rs.normal(0, 0.05, x.shape).astype(np.float32)) for x in p]
    out = {}
    for dev in ("cpu", cuda_device):
        v = [x.to(dev) for x in q]
        fit = bvh.refit(tree, *v)
        o = torch.as_tensor(order, device=dev).long()
        pk = bvh.pack_update(packed, tree, v[0][o], (v[1] - v[0])[o], (v[2] - v[0])[o],
                             refitted=fit)
        out[str(dev)] = (fit.aabb_min, fit.aabb_max, pk.nodes, pk.records)
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        _boxes_equal(a, b)
    assert out["cpu"][3].numpy().tobytes() == out[str(cuda_device)][3].cpu().numpy().tobytes()


def test_kernel_on_refitted_tables_is_its_plain_version(cuda_device):
    """The skinned strips built at rest and refit to two later poses on the
    card: the traversal kernel and its plain version on 64x48 primary rays
    of the refitted tables, bit-identical; the closest t that of a fresh
    build at the same pose."""
    anim, *_ = bench_scene.build_animated_scene("skinned", 64, 48, cuda_device, strips=8)
    c2w = bench_scene.anim_camera("skinned", 64, 48, bench_scene.ANIM_GOLDEN_VIEWS)
    px, py = torch.meshgrid(torch.arange(64, device=cuda_device),
                            torch.arange(48, device=cuda_device), indexing="xy")
    o, d, t_max = rz._pixel_rays(px.reshape(-1), py.reshape(-1), (64, 48),
                                 torch.as_tensor(c2w, device=cuda_device))
    zero = torch.zeros_like(t_max)
    for delta in (0.4, 0.9):
        anim.update(delta)
        s, m = anim.ptscene, anim.meta
        args = (s.wide_nodes, s.wide_maps.meta, s.leaf_records, s.leaf_words, o, d, zero, t_max,
                m.wide_root, False, 0, 0, None)
        k = tr.traverse_wide(*args, stack_bound=m.stack_bound)
        r = tr.traverse_wide_ref(*args, stack_bound=m.stack_bound)
        for a, b in zip(k, r):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert int((k[1] >= 0).sum()) > 100
        fresh, *_ = bench_scene.build_animated_scene("skinned", 64, 48, cuda_device, strips=8,
                                                     time=anim.player.time)
        hb = pt.closest_hit(fresh.ptscene, fresh.meta, o, d, zero, t_max)
        assert torch.equal(k[0].view(torch.int32), hb.t.view(torch.int32))


def test_native_piz_builds_and_decodes(cuda_device):
    """The card's host builds native/exr_piz.cpp with g++ and decodes a PIZ
    block to the Python decoder's bytes."""
    from gltf_renderer_tpu_torch.env import piz

    lib = piz.native_piz()
    assert hasattr(lib, "piz_decode")
    img = bench_scene.analytic_sky(32, 64).astype(np.float16)
    raw = img.tobytes()
    channels = [("B", 1), ("G", 1), ("R", 1)]
    blob = piz.piz_compress(raw, channels, 64, 32)
    before = piz.NATIVE_DECODES
    assert piz.piz_uncompress(blob, channels, 64, 32) == raw
    assert piz.piz_uncompress(blob, channels, 64, 32, allow_native=False) == raw
    assert piz.NATIVE_DECODES == before + 1
