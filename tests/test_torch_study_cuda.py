"""The warm-up, brute-force and per-lane fetch kernels against their plain
PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_study_cuda.py -q

Without a CUDA device every test here skips (the kernels have no CPU mode).
Tolerance: none for the warm-up and per-lane kernels, which repeat their
plain versions' operations in the same order, each rounded on its own
(built with -fmad=false), so the outputs are identical. The brute-force
kernel sums its products on the tensor cores, in an order the hardware
fixes, so it is held to its plain version by ops/brute.compare_winners:
every ray agrees or is explained by rounding, at least 99.9% agree where
the rays are not built to graze, and the kernel's sums lie within the
contract's delta (2^-16 of sum |f c|) of the exact ones.
"""

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch.ops import brute, perlane, warm
from gltf_renderer_tpu_torch.tools import bench_mxu, bench_perlane

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _identical(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_warm_kernel_matches_plain(cuda_device):
    launches = warm.KERNEL_LAUNCHES
    assert bool((warm.warm(cuda_device) == 1.0).all())
    x = torch.randn((8, 128), device=cuda_device) * 1e6
    _identical(warm.add_one(x), warm.warm_ref(x))
    assert warm.KERNEL_LAUNCHES == launches + 2


def test_brute_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(4)
    n_rays, n_tris = 3 * brute.RB, 5 * brute.TB
    o = rng.normal(size=(n_rays, 3)).astype(np.float32) * 2
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.where(rng.random(n_rays) < 0.3, 1.0, 0.0).astype(np.float32)
    tmax = np.where(rng.random(n_rays) < 0.3, 2.5, 100.0).astype(np.float32)
    tris = [rng.normal(size=(n_tris, 3)).astype(np.float32) * s for s in (1.0, 0.3, 0.3)]
    launches = brute.KERNEL_LAUNCHES
    sets = {"correctness": bench_mxu.correctness_data(), "clipped": (o, d, tmin, tmax, *tris),
            "grazing": bench_mxu.grazing_data(n_rays, n_tris, seed=4)}
    for name, data in sets.items():
        ins = bench_mxu.brute_inputs(*data, cuda_device)
        got = brute.brute_closest(*ins)
        want = brute.brute_closest_ref(*ins)
        sample = torch.arange(brute.RAYS_PER_CTA, device=cuda_device)
        res = brute.compare_winners(ins, got, want,
                                    sums=(sample, brute.brute_sums(ins[0][sample], *ins[3:])))
        assert res["unexplained"] == 0, (name, res)
        assert res["max_sum_dev"] <= brute.DELTA, (name, res)
        if name != "grazing":
            assert res["agree"] >= 0.999 * res["rays"], (name, res)
        assert 0 < int((want[1] >= 0).sum()) < ins[0].shape[0]
    assert brute.KERNEL_LAUNCHES == launches + len(sets)


def test_brute_kernel_refuses_ragged_rays(cuda_device):
    ins = bench_mxu.brute_inputs(*bench_mxu.correctness_data(), cuda_device)
    feats, tmin, tmax, *slabs = ins
    with pytest.raises(ValueError, match="multiple of 1024"):
        brute.brute_closest(feats[:1000], tmin[:1000], tmax[:1000], *slabs)


@pytest.mark.parametrize("label,n,c", bench_perlane.SHAPES)
def test_perlane_kernels_match_plain(cuda_device, label, n, c):
    rng = np.random.RandomState(n)
    launches = dict(perlane.KERNEL_LAUNCHES)
    ids, table = bench_perlane.onehot_inputs(rng, n, c, cuda_device)
    _identical(perlane.onehot_fetch(ids, table, 32), perlane.onehot_fetch_ref(ids, table, 32))
    ids, table = bench_perlane.shuffle_inputs(rng, n, c, cuda_device)
    ids[0, :3] = torch.tensor([-5, n + 7, 10 * n], dtype=torch.int32)  # outside: zeros
    _identical(perlane.shuffle_fetch(ids, table, n, c, 32),
               perlane.shuffle_fetch_ref(ids, table, n, c, 32))
    assert perlane.KERNEL_LAUNCHES == {k: v + 1 for k, v in launches.items()}
