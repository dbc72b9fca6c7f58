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

import perlane_tables

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


def _layouts(table):
    """The table as it is (16-byte aligned) and a copy one element off
    16-byte alignment (4 bytes for f32: the shuffle kernel reads it in
    place; 2 for bf16: the onehot kernel reads each row's 8 columns by
    two-byte loads)."""
    flat = torch.empty(table.numel() + 1, dtype=table.dtype, device=table.device)
    off = flat[1:].view(table.shape)
    off.copy_(table)
    assert table.data_ptr() % 16 == 0 and off.data_ptr() % 16 == table.element_size()
    return [table, off]


def _awkward_ids(rs, n):
    """(1, 128) int32: ids in the table, in its padding above n, above it,
    negative and at the int32 edges."""
    ids = rs.randint(0, n, (1, perlane.LANES)).astype(np.int32)
    pad = -(-n // perlane.LANES) * perlane.LANES
    ids[0, :8] = [-1, -n - 5, n, pad - 1, pad, 10 * pad, -2 ** 31, 2 ** 31 - 1]
    return ids


@pytest.mark.parametrize("kind", perlane_tables.KINDS)
def test_perlane_kernels_on_adversarial_tables(cuda_device, kind):
    """Both kernels equal their plain versions bit for bit where the
    fetched values are negative, wrap the int32 sum, saturate the cast or
    are NaN or +-inf (tests/perlane_tables.py; in the onehot kernel the
    last two poison every lane); the shuffle kernel staged and in place,
    on a small table and the tool's three shapes."""
    rs = np.random.RandomState(len(kind))
    calls = 0
    launches = dict(perlane.KERNEL_LAUNCHES)
    for n, c in [(200, 8)] + [(n, c) for _, n, c in bench_perlane.SHAPES]:
        ids = torch.from_numpy(_awkward_ids(rs, n)).to(cuda_device)
        table = torch.from_numpy(perlane_tables.shuffle_table(rs, n, c, kind)).to(cuda_device)
        want = perlane.shuffle_fetch_ref(ids, table, n, c, 33)
        for t in _layouts(table):
            _identical(perlane.shuffle_fetch(ids, t, n, c, 33), want)
            calls += 1
        o_ids = torch.from_numpy(rs.randint(0, n, (perlane.ROWS, perlane.LANES))
                                 .astype(np.int32)).to(cuda_device)
        o_table = torch.from_numpy(perlane_tables.adversarial_table(rs, n, c, kind)).to(
            cuda_device, torch.bfloat16)
        _identical(perlane.onehot_fetch(o_ids, o_table, 33),
                   perlane.onehot_fetch_ref(o_ids, o_table, 33))
    onehots = len(bench_perlane.SHAPES) + 1
    assert perlane.KERNEL_LAUNCHES == {"onehot_fetch": launches["onehot_fetch"] + onehots,
                                       "shuffle_fetch": launches["shuffle_fetch"] + calls}


@pytest.mark.parametrize("n", [1, 129, 30000])
def test_shuffle_kernel_edge_shapes(cuda_device, n):
    """One-row and one-past-a-group tables and one too large to stage
    (30,000 rows: 470 KB for two columns), 1, 3, 112 and 160 columns, 0, 1,
    2 and 33 steps, ids outside the table and negative: bit-identical,
    staged and in place."""
    rs = np.random.RandomState(n)
    assert 2 * -(-30000 // perlane.LANES) * perlane.LANES * 4 > 227 * 1024  # 2 columns
    for c in (1, 3, 112, 160):
        ids = torch.from_numpy(_awkward_ids(rs, n)).to(cuda_device)
        table = torch.from_numpy(perlane_tables.shuffle_table(rs, n, c, "wrap")).to(cuda_device)
        for steps in (0, 1, 2, 33):
            want = perlane.shuffle_fetch_ref(ids, table, n, c, steps)
            for t in _layouts(table):
                _identical(perlane.shuffle_fetch(ids, t, n, c, steps), want)


@pytest.mark.parametrize("n", [1, 7, 9, 768, 6400, 60000])
def test_onehot_kernel_edge_shapes(cuda_device, n):
    """The onehot kernel bit for bit against its plain version: one row,
    row counts that split unevenly over the cluster's 8 blocks and into
    its 4-row stores, the tool's node shapes, and 60,000 rows (240 KB of
    sums, too large to stage: the rows are read in place); 8, 9 and 160
    columns (9: rows off 16-byte alignment), each table aligned and 2
    bytes off; 0, 1, 2 and 33 steps; ids outside the table at step 0, the
    int32 edges among them; a table of wrapping sums and one whose lone
    +inf lies on a row a quarter of the lanes start on (those lanes keep
    their sum, the rest are poisoned)."""
    rs = np.random.RandomState(n)
    assert 4 * 60000 > 227 * 1024
    launches = perlane.KERNEL_LAUNCHES["onehot_fetch"]
    calls = 0
    for c in (8, 9, 160):
        ids = rs.randint(0, n, (perlane.ROWS, perlane.LANES)).astype(np.int32)
        ids[0, :8] = [-1, -n - 5, n, n + 3, 10 * n, -2 ** 31, 2 ** 31 - 1, 2 ** 31 - 2]
        lone = (rs.rand(n, c) * 3).astype(np.float32)
        lone[n // 2, 3] = np.inf
        ids[4:8] = n // 2
        ids = torch.from_numpy(ids).to(cuda_device)
        for kind, t in (("wrap", perlane_tables.adversarial_table(rs, n, c, "wrap")),
                        ("lone", lone)):
            table = torch.from_numpy(t).to(cuda_device, torch.bfloat16)
            for steps in (0, 1, 2, 33):
                want = perlane.onehot_fetch_ref(ids, table, steps)
                if kind == "lone" and steps == 1:
                    on = ids == n // 2
                    assert bool(torch.isinf(want[on]).all() & torch.isnan(want[~on]).all())
                for t_ in _layouts(table):
                    _identical(perlane.onehot_fetch(ids, t_, steps), want)
                    calls += 1
    assert perlane.KERNEL_LAUNCHES["onehot_fetch"] == launches + calls


def test_l2_latency_probe(cuda_device):
    """The pointer chase's L2 hit latency is a load's, not a kernel launch's
    or a memory-bound stream's: between 50 ns and 2 us, and the same length
    of chain twice gives the same latency within 20%. The L1 chase hits L1:
    faster than L2, and above 5 ns. The shared-memory chase is faster
    than L2 and above 2 ns, and 32 lanes at scattered words (bank
    conflicts) take no less than one lane."""
    a = bench_perlane.hit_latency_ns(cuda_device, "l2")
    b = bench_perlane.hit_latency_ns(cuda_device, "l2")
    assert 50.0 < a < 2000.0 and abs(a - b) < 0.2 * a
    l1 = bench_perlane.hit_latency_ns(cuda_device, "l1")
    assert 5.0 < l1 < 0.8 * a
    smem = bench_perlane.hit_latency_ns(cuda_device, "smem")
    warp = bench_perlane.hit_latency_ns(cuda_device, "smem", lanes=32)
    assert 2.0 < smem < 0.8 * a and warp > 0.9 * smem
