"""The plain side of the brute-force kernel's contract (ops/brute.py), on
the CPU, without JAX: the kernel's tile layout (`pack_slabs`), its
winner rule, and `compare_winners`, which holds the tensor-core kernel to
its plain version where the two sum the 16 products in different orders.

Every case is at most 1,024 rays x 1,536 triangles. Tolerances: none for
the layout and the winner rule (integers); `compare_winners`' delta is
2^-16 of sum |f c| (its docstring says why); a sum in another f32 order
lies within 16 * 2^-24 of sum |f c| of the exact one.
"""

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch.ops import brute
from gltf_renderer_tpu_torch.tools import bench_mxu

torch.set_num_threads(2)


def _soup(n_rays, n_tris, seed, tmin=0.0, tmax=100.0):
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.3
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.3
    o = rng.normal(size=(n_rays, 3)).astype(np.float32) * 2
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o, d, np.full(n_rays, tmin, np.float32), np.full(n_rays, tmax, np.float32),
            v0, e1, e2)


CASES = {
    "correctness_data": bench_mxu.correctness_data,
    "three_blocks_clipped": lambda: _soup(1024, 3 * brute.TB, seed=5, tmin=0.5, tmax=3.0),
    "grazing": lambda: bench_mxu.grazing_data(1024, 3 * brute.TB, seed=3),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    ins = bench_mxu.brute_inputs(*CASES[request.param](), "cpu")
    return request.param, ins, brute.brute_closest_ref(*ins)


def _pairwise_ref(ins, monkeypatch):
    """The plain version with each 16-term sum taken as a pairwise tree in
    f32 ((0+1)+(2+3))+... instead of in order k = 0..15."""
    def tree(f, c):
        x = [f[:, k:k + 1] * c[k] for k in range(16)]
        while len(x) > 1:
            x = [x[i] + x[i + 1] for i in range(0, len(x), 2)]
        return x[0]

    monkeypatch.setattr(brute, "_dot16", tree)
    return brute.brute_closest_ref(*ins), torch.stack(
        [tree(ins[0][:256].float(), c.float()) for c in ins[3:]])


def test_pack_slabs_layout_and_round_trip():
    ins = bench_mxu.brute_inputs(*_soup(8, 3 * brute.TB, seed=2), "cpu")
    slabs = ins[3:]
    tiles = brute.pack_slabs(*slabs)
    t = slabs[0].shape[1]
    assert tiles.is_contiguous() and tuple(tiles.shape) == (t // brute.TN, 16, 2, 8, 8)
    assert tiles.dtype == torch.bfloat16 and tiles[0].numel() * 2 == 4096  # one 4 KB tile
    # Tile i, column n = q * TN + j, depth k: quantity q of triangle i * TN + j.
    for i in (0, 1, t // brute.TN - 1):
        for q in range(4):
            for j in (0, 7, 8, 31):
                n = q * brute.TN + j
                col = tiles[i, n // 8, :, n % 8, :].reshape(16)
                assert torch.equal(col, slabs[q][:, i * brute.TN + j])
    # Round trip: the inverse permutation gives back the four slabs.
    back = tiles.view(t // brute.TN, 4, 4, 2, 8, 8).permute(1, 3, 5, 0, 2, 4).reshape(4, 16, t)
    for q in range(4):
        assert torch.equal(back[q], slabs[q])
    # Byte layout: column 8g + r at depth 8c + e lies at g*256 + c*128 + r*16 + e*2.
    flat = tiles[0].reshape(-1)
    for g, c, r, e in ((0, 0, 0, 0), (3, 1, 5, 7), (15, 1, 7, 3)):
        assert flat[(g * 256 + c * 128 + r * 16 + e * 2) // 2] == tiles[0, g, c, r, e]


def test_lexicographic_minimum_is_the_running_minimum(case):
    """The kernel's rule: each thread keeps the least (key, blk) over its
    triangles in tile order, then the quad's four threads take the
    lexicographic minimum. It equals brute_closest_ref's per-block minimum
    followed by a strictly-less running minimum over blocks."""
    _, ins, (key_ref, blk_ref) = case
    feats, tmin, tmax, *slabs = ins
    f = feats.float()
    det, ud, vd, td = (brute._dot16(f, c.float()) for c in slabs)
    m3, m4, m5 = det - ud - vd, td - tmin * det, tmax * det - td
    terms = torch.stack((ud, vd, m3, m4, m5))
    hit = ((det > 0) & (terms >= 0).all(0)) | ((det < 0) & (terms <= 0).all(0))
    tb = torch.where(hit, td / det, torch.tensor(float("inf")))
    t = det.shape[1]
    tri = torch.arange(t)
    key = (tb.view(torch.int32) & ~brute.LANE_BITS) | (tri % brute.TB).int()
    blk = (tri // brute.TB).long()
    combined = key.long() * (1 << 20) + blk  # lexicographic (key, blk), blk < 2^20
    quad_thread = (tri % brute.TN % 8) // 2  # the accumulator column's thread in its quad
    best = torch.full((det.shape[0],), brute.KEY_INIT * (1 << 20) - 1, dtype=torch.int64)
    for th in range(4):
        best = torch.minimum(best, combined[:, quad_thread == th].amin(1))
    miss = best == brute.KEY_INIT * (1 << 20) - 1
    got_key = torch.where(miss, brute.KEY_INIT, best.div(1 << 20, rounding_mode="floor"))
    got_blk = torch.where(miss, -1, best % (1 << 20))
    assert torch.equal(got_key.int(), key_ref[:, 0])
    assert torch.equal(got_blk.int(), blk_ref[:, 0])


def test_plain_version_against_itself(case):
    _, ins, want = case
    sample = torch.arange(256)
    res = brute.compare_winners(ins, want, want, sums=(sample, brute.brute_sums(ins[0][:256],
                                                                                *ins[3:])))
    assert res["agree"] == res["rays"] == ins[0].shape[0]
    assert res["explained"] == res["unexplained"] == 0
    assert res["both_hit"] == int((want[1] >= 0).sum()) > 0
    assert res["max_sum_dev"] <= 16 * 2.0 ** -24  # the ordered f32 sum's error bound


def test_another_summation_order_disagrees_only_where_explained(monkeypatch):
    ins = bench_mxu.brute_inputs(*CASES["grazing"](), "cpu")
    want = brute.brute_closest_ref(*ins)
    got, sums = _pairwise_ref(ins, monkeypatch)
    res = brute.compare_winners(ins, got, want, sums=(torch.arange(256), sums))
    assert res["explained"] > 0  # the exactly grazing rays tip both ways
    assert res["unexplained"] == 0, res
    assert res["agree"] + res["explained"] == res["rays"]
    assert 0 < res["max_sum_dev"] <= 16 * 2.0 ** -24
    # The rays that cross an edge exactly are the ones that disagree.
    differ = (got[1] != want[1]) | (got[0] != want[0])
    assert bool((torch.arange(1024)[differ[:, 0]] % 16 == 15).all())


def test_grazing_rays_cross_edges_exactly():
    o, d, tmin, tmax, v0, e1, e2 = CASES["grazing"]()
    ins = bench_mxu.brute_inputs(o, d, tmin, tmax, v0, e1, e2, "cpu")
    exact = np.arange(15, 1024, 16)
    own = [int(np.flatnonzero((v0 == o[j] + 4096 * d[j] - e1 * 0.5).all(1))[0]) for j in exact]
    # Every input of those rays and their triangles is exact in bf16 ...
    np.testing.assert_array_equal(ins[0].float().numpy()[exact],
                                  brute.ray_features(o, d)[exact])
    for got, want in zip(ins[3:], brute.mt_coefficients(v0, e1, e2)):
        np.testing.assert_array_equal(got.float().numpy()[:, own], want[:, own])
    # ... and each one's edge term against its own triangle is 0 exactly,
    # with features from 2^-36 to 2^24 (so f32 partial sums round).
    f = ins[0].double()[exact]
    vd = (f * ins[5].double()[:, own].T).sum(1)
    assert bool((vd == 0).all())
    mags = f.abs()[f != 0]
    assert float(mags.max() / mags.min()) >= 2.0 ** 50


def test_replaced_winners_are_unexplained():
    """k rays' answers made wrong beyond rounding: three name a triangle
    moved 1,000 units away (past every ray's t_max), two report a miss."""
    o, d, tmin, tmax, v0, e1, e2 = CASES["three_blocks_clipped"]()
    far = 3 * brute.TB - 1
    v0 = v0.copy()
    v0[far] += 1000.0
    ins = bench_mxu.brute_inputs(o, d, tmin, tmax, v0, e1, e2, "cpu")
    want = brute.brute_closest_ref(*ins)
    key, blk = (x.clone() for x in want)
    hits = torch.nonzero(blk[:, 0] >= 0)[:, 0]
    k = 5
    moved, missed = hits[:3], hits[3:k]
    key[moved, 0] = (key[moved, 0] & ~brute.LANE_BITS) | (far % brute.TB)
    blk[moved, 0] = far // brute.TB
    key[missed, 0] = brute.KEY_INIT
    blk[missed, 0] = -1
    res = brute.compare_winners(ins, (key, blk), want)
    assert res["unexplained"] == k and res["explained"] == 0, res
    assert sorted(res["unexplained_rays"]) == hits[:k].tolist()
    assert res["agree"] == res["rays"] - k
