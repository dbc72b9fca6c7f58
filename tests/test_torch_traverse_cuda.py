"""The CUDA traversal kernel against its plain PyTorch version, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_traverse_cuda.py -q

Without a CUDA device every test here skips (the kernel has no CPU mode).
Both visit children nearest first (entry distance, then child index).
Tolerance: none. The kernel and `traverse_wide_ref` visit nodes in the same
order and round every operation the same way (the kernel is built with
-fmad=false), so words, t, u and v are identical.
"""

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch.ops import bvh
from gltf_renderer_tpu_torch.ops import traverse as tr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _soup_tables(n_tris, seed):
    """Random triangle soup in [-1, 1]^3 with random MASKED / BLEND /
    DOUBLE_SIDED flags, as wide tables (numpy)."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    p0, p1, p2 = [c + rs.uniform(-0.25, 0.25, (n_tris, 3)).astype(np.float32)
                  for _ in range(3)]
    tree = bvh.build(p0, p1, p2)
    order = tree.tri_order
    words = order.astype(np.int64).copy()
    for flag in (bvh.FLAG_MASKED, bvh.FLAG_BLEND, bvh.FLAG_DOUBLE_SIDED):
        words |= np.where(rs.rand(n_tris) < 0.3, flag, 0)
    packed = bvh.pack(tree, p0[order], (p1 - p0)[order], (p2 - p0)[order],
                      words.astype(np.int32))
    maps, root = bvh.build_wide_maps(tree)
    return dict(nodes=bvh.assemble_wide(packed.nodes, maps.child_src), meta=maps.meta,
                records=packed.records[maps.leaf_ids], words=packed.words[maps.leaf_ids],
                root=root, stack_bound=bvh.wide_stack_bound(maps.meta, root))


def _rays(n, seed):
    """Random, coherent (one eye) and axis-aligned rays (numpy)."""
    rs = np.random.RandomState(seed)
    o = np.concatenate([rs.uniform(-3, 3, (n, 3)),
                        np.tile([[0.0, -3.0, 0.0]], (n, 1)),
                        [[0, -3, 0], [-3, 0, 0], [0, 0, 3]]]).astype(np.float32)
    d = np.concatenate([rs.uniform(-1, 1, (n, 3)),
                        rs.uniform(-1, 1, (n, 3)) - [[0.0, -3.0, 0.0]],
                        [[0, 1, 0], [1, 0, 0], [0, 0, -1]]]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.where(rs.rand(o.shape[0]) < 0.1, 2.0, 0.0).astype(np.float32)
    t_max = np.full(o.shape[0], 20.0, np.float32)
    return o, d, t_min, t_max


@pytest.mark.parametrize("n_tris", [300, 5000])
def test_kernel_matches_plain_on_card(cuda_device, n_tris):
    tables = _soup_tables(n_tris, seed=n_tris)
    o, d, tmn, tmx = _rays(2048, seed=3)
    mode = (np.random.RandomState(4).rand(o.shape[0]) < 0.5).astype(np.int32)
    T = lambda x: torch.from_numpy(np.array(x)).to(cuda_device)
    base = [T(tables[k]) for k in ("nodes", "meta", "records", "words")]
    launches = tr.KERNEL_LAUNCHES
    for any_hit, m in ((False, None), (True, None), ("lane", mode)):
        for cull in (-1, 0, 1):
            for blend in (0, 1, 2):
                args = base + [T(o), T(d), T(tmn), T(tmx), tables["root"], any_hit, cull,
                               blend, None if m is None else T(m)]
                got = [x.cpu().numpy() for x in
                       tr.traverse_wide(*args, stack_bound=tables["stack_bound"])]
                want = [x.cpu().numpy() for x in
                        tr.traverse_wide_ref(*args, stack_bound=tables["stack_bound"])]
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
                assert (want[1] >= 0).any()
    assert tr.KERNEL_LAUNCHES == launches + 27


def test_kernel_matches_plain_in_lane_mode_at_main_path_size(cuda_device):
    """524,288 lane-mixed rays, the size of the path tracer's merged bounce +
    shadow launch at 1080p spp=4."""
    tables = _soup_tables(5000, seed=9)
    o, d, tmn, tmx = [x[:524_288] for x in _rays(262_143, seed=5)]
    mode = (np.random.RandomState(6).rand(o.shape[0]) < 0.5).astype(np.int32)
    T = lambda x: torch.from_numpy(np.array(x)).to(cuda_device)
    args = [T(tables[k]) for k in ("nodes", "meta", "records", "words")] + [
        T(o), T(d), T(tmn), T(tmx), tables["root"], "lane", 0, 0, T(mode)]
    launches = tr.KERNEL_LAUNCHES
    got = tr.traverse_wide(*args, stack_bound=tables["stack_bound"])
    want = tr.traverse_wide_ref(*args, stack_bound=tables["stack_bound"])
    assert tr.KERNEL_LAUNCHES == launches + 1
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (want[1] >= 0).sum() > 1000


def _shifted(x, cuda_device):
    """A contiguous copy of x that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 4
    return out


def test_kernel_refuses_misaligned_leaf_rows(cuda_device):
    tables = _soup_tables(300, seed=1)
    o, d, tmn, tmx = _rays(16, seed=2)
    T = lambda x: torch.from_numpy(np.array(x)).to(cuda_device)
    base = [T(tables[k]) for k in ("nodes", "meta", "records", "words")]
    rays = [T(o), T(d), T(tmn), T(tmx), tables["root"]]
    launches = tr.KERNEL_LAUNCHES
    for k in (2, 3):
        args = list(base)
        args[k] = _shifted(base[k], cuda_device)
        with pytest.raises(ValueError, match="16-byte aligned"):
            tr.traverse_wide(*args, *rays, stack_bound=tables["stack_bound"])
    assert tr.KERNEL_LAUNCHES == launches


def test_kernel_refuses_a_stack_past_shared_memory(cuda_device):
    """The stack, one int per thread and level, must fit the 227 KB one
    block may use: the largest bound taken is launched, one more refused."""
    tables = _soup_tables(300, seed=1)
    o, d, tmn, tmx = _rays(16, seed=2)
    T = lambda x: torch.from_numpy(np.array(x)).to(cuda_device)
    args = [T(tables[k]) for k in ("nodes", "meta", "records", "words")] + [
        T(o), T(d), T(tmn), T(tmx), tables["root"]]
    most = tr.max_stack_bound()
    assert most >= 64
    want = tr.traverse_wide_ref(*args, stack_bound=tables["stack_bound"])
    got = tr.traverse_wide(*args, stack_bound=most)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    with pytest.raises(ValueError, match="shared memory"):
        tr.traverse_wide(*args, stack_bound=most + 1)


def test_kernel_refuses_a_stack_it_was_not_built_for(cuda_device):
    tables = _soup_tables(300, seed=1)
    o, d, tmn, tmx = _rays(16, seed=2)
    T = lambda x: torch.from_numpy(np.array(x)).to(cuda_device)
    args = [T(tables[k]) for k in ("nodes", "meta", "records", "words")] + [
        T(o), T(d), T(tmn), T(tmx), tables["root"]]
    with pytest.raises(ValueError):
        tr.traverse_wide(*args, stack_bound=10_000)
