"""Torch port of the brute-force closest-hit study (ops/brute.py,
tools/bench_mxu.py in the port) vs tools/bench_mxu.py.

The plain version `brute_closest_ref` is held against the TPU kernel
`make_brute_kernel` run in interpret mode. Features and coefficients are
rounded to bf16 once, by torch, and handed to JAX as those f32 values, which
`jnp.asarray(..., bfloat16)` converts exactly; both then see the same
inputs. Tolerance: none. key and blk must be identical for every ray: the
products are exact in f32 up to the sum's rounding, the port sums in order
k = 0..15, and only 14 bits of t's mantissa reach the key.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu_torch.ops import brute
from gltf_renderer_tpu_torch.tools import bench_mxu as port_mxu
from tools import bench_mxu as jax_mxu

torch.set_num_threads(2)


def _soup(n_rays, n_tris, seed, tmin=0.0, tmax=100.0):
    """Random rays and triangles as bench_mxu.correctness_check makes them."""
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.3
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.3
    o = rng.normal(size=(n_rays, 3)).astype(np.float32) * 2
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o, d, np.full(n_rays, tmin, np.float32), np.full(n_rays, tmax, np.float32),
            v0, e1, e2)


def _jax_kernel(ins):
    feats, tmin, tmax, *slabs = [x.float().numpy() for x in ins]
    run = jax_mxu.make_brute_kernel(slabs[0].shape[1], interpret=True)
    key, blk = run(jnp.asarray(feats, jnp.bfloat16), jnp.asarray(tmin), jnp.asarray(tmax),
                   *[jnp.asarray(c, jnp.bfloat16) for c in slabs])
    return np.asarray(key), np.asarray(blk)


CASES = {
    # tools/bench_mxu.py's correctness data: 1,024 rays x 2 blocks.
    "correctness_data": port_mxu.correctness_data,
    # 3 triangle blocks, t_min past the near hits and a short t_max.
    "three_blocks_clipped": lambda: _soup(1024, 3 * brute.TB, seed=5, tmin=0.5, tmax=3.0),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    data = CASES[request.param]()
    ins = port_mxu.brute_inputs(*data, "cpu")
    return data, ins, _jax_kernel(ins)


def test_host_helpers_equal_the_tool():
    o, d, _, _, v0, e1, e2 = port_mxu.correctness_data()
    for got, want in zip(brute.mt_coefficients(v0, e1, e2), jax_mxu.mt_coefficients(v0, e1, e2)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(brute.ray_features(o, d), jax_mxu.ray_features(o, d))
    data = port_mxu.correctness_data()
    for got, want in zip(brute.brute_reference(*data), jax_mxu.brute_reference(*data)):
        np.testing.assert_array_equal(got, want)


def test_plain_version_equals_the_tpu_kernel(case):
    _, ins, (key_j, blk_j) = case
    key, blk = brute.brute_closest(*ins)  # CPU tensors: the plain version
    assert key.dtype == blk.dtype == torch.int32 and tuple(key.shape) == (ins[0].shape[0], 1)
    np.testing.assert_array_equal(key.numpy(), key_j)
    np.testing.assert_array_equal(blk.numpy(), blk_j)
    hits = blk.numpy() >= 0
    assert 0.05 < hits.mean() < 0.95  # both hits and misses are exercised
    assert (key.numpy()[~hits] == brute.KEY_INIT).all()


def test_decode_winner_equals_the_tool(case):
    data, ins, (key_j, blk_j) = case
    key, blk = brute.brute_closest_ref(*ins)
    t_p, tri_p = brute.decode_winner(key.numpy(), blk.numpy())
    t_j, tri_j = jax_mxu.decode_winner(key_j, blk_j)
    np.testing.assert_array_equal(tri_p, tri_j)
    np.testing.assert_array_equal(t_p, t_j)
    # Against exact numpy Moller-Trumbore, the tool's own bar.
    _, tri_r = brute.brute_reference(*data)
    assert ((tri_p < 0) == (tri_r < 0)).mean() > 0.97


def test_plain_version_chunks_give_the_same_answer(case, monkeypatch):
    _, ins, (key_j, blk_j) = case
    monkeypatch.setattr(brute, "CHUNK_ELEMS", 100 * ins[3].shape[1])  # ragged ray chunks
    key, blk = brute.brute_closest_ref(*ins)
    np.testing.assert_array_equal(key.numpy(), key_j)
    np.testing.assert_array_equal(blk.numpy(), blk_j)


def test_wrapper_refuses_ragged_shapes():
    ins = port_mxu.brute_inputs(*_soup(2048, brute.TB, seed=1), "cpu")
    feats, tmin, tmax, *slabs = ins
    with pytest.raises(ValueError, match="multiple of 1024"):
        brute.brute_closest(feats[:1000], tmin[:1000], tmax[:1000], *slabs)
    with pytest.raises(ValueError, match="multiple of 512"):
        brute.brute_closest(feats, tmin, tmax, *[c[:, :500] for c in slabs])
    with pytest.raises(TypeError):
        brute.brute_closest(feats.float(), tmin, tmax, *slabs)


def test_scale_inputs_equal_the_tool():
    """The scale timing's inputs are tools/bench_mxu.py scale_timing's: the
    same draws from seed 1, rounded to bf16 once. Tolerance: none."""
    rng = np.random.default_rng(1)
    r = 262144
    o = rng.normal(size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bf16 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16()
    names = []
    for (name, ins), (t_real, want_name) in zip(port_mxu.scale_inputs("cpu"),
                                                ((48768, "helmet"), (274432, "courtyard"))):
        t_pad = -(-t_real // jax_mxu.TB) * jax_mxu.TB
        v0 = rng.normal(size=(t_pad, 3)).astype(np.float32)
        e1 = rng.normal(size=(t_pad, 3)).astype(np.float32) * 0.1
        e2 = rng.normal(size=(t_pad, 3)).astype(np.float32) * 0.1
        feats, tmin, tmax, *slabs = ins
        assert torch.equal(feats, bf16(jax_mxu.ray_features(o, d)))
        assert (tmin == 0).all() and (tmax == 100).all() and tuple(tmin.shape) == (r, 1)
        for got, want in zip(slabs, jax_mxu.mt_coefficients(v0, e1, e2)):
            assert torch.equal(got, bf16(want))
        names.append(name)
        assert name == want_name
    assert names == ["helmet", "courtyard"]


def test_tool_correctness_check_on_cpu(capsys):
    assert port_mxu.main("cpu") is None
    out = capsys.readouterr().out
    assert "hit/miss agreement" in out and "CPU: correctness only" in out
