"""Torch port RNG vs the JAX package and the pure-Python uint32 models.

pcg3d / pcg4d / pt_random must be bit-exact: the path tracer's per-pixel
sample sequence depends on every bit. Inputs include values >= 2^31, where
int64 emulation of uint32 arithmetic is easiest to get wrong.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.ops import rng as jrng
from gltf_renderer_tpu_torch.ops import rng as prng
from tests.test_rng import pcg3d_py, pcg4d_py

torch.set_num_threads(2)
M32 = 0xFFFFFFFF


def _cases(n_cols, seed):
    rs = np.random.default_rng(seed)
    fixed = np.asarray([[0] * n_cols, list(range(1, n_cols + 1)), [M32] * n_cols,
                        [2 ** 31] * n_cols, [2 ** 31 - 1, 2 ** 32 - 2, 7, 2 ** 31 + 5][:n_cols]],
                       np.uint64)
    rand = rs.integers(0, 2 ** 32, size=(200, n_cols), dtype=np.uint64)
    return np.concatenate([fixed, rand]).astype(np.uint32)


def test_pcg4d_matches_jax_and_python():
    cases = _cases(4, 1)
    got = prng.pcg4d(torch.from_numpy(cases.astype(np.int64))).numpy()
    want_jax = np.asarray(jrng.pcg4d(jnp.asarray(cases, jnp.uint32))).astype(np.int64)
    want_py = np.asarray([pcg4d_py([int(x) for x in c]) for c in cases], np.int64)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_py)


def test_pcg3d_matches_jax_and_python():
    cases = _cases(3, 2)
    got = prng.pcg3d(torch.from_numpy(cases.astype(np.int64))).numpy()
    want_jax = np.asarray(jrng.pcg3d(jnp.asarray(cases, jnp.uint32))).astype(np.int64)
    want_py = np.asarray([pcg3d_py([int(x) for x in c]) for c in cases], np.int64)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_py)


@pytest.mark.parametrize("seed,counter", [(0, 0), (1234, 5), (2 ** 31 + 17, 3),
                                          (0x9E3779B9 * 3 & M32, 7)])
def test_pt_random_bit_exact(seed, counter):
    rs = np.random.default_rng(seed & 0xFFFF)
    px = rs.integers(0, 1920, 500).astype(np.int32)
    py = rs.integers(0, 1080, 500).astype(np.int32)
    got = prng.pt_random(torch.from_numpy(px), torch.from_numpy(py), seed, counter).numpy()
    want = np.asarray(jrng.pt_random(jnp.asarray(px), jnp.asarray(py), seed, counter))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_pt_random_per_ray_seed_vector():
    """trace_chunked(spp > 1) keys each ray by its own uint32 seed."""
    px = torch.arange(64, dtype=torch.int32)
    py = torch.arange(64, dtype=torch.int32) * 3
    seeds = torch.tensor([(5 + k * 0x9E3779B9) & M32 for k in range(4)], dtype=torch.int64)
    seed_vec = seeds.repeat_interleave(16)
    got = prng.pt_random(px, py, seed_vec, 2).numpy()
    for k in range(4):
        want = np.asarray(jrng.pt_random(jnp.asarray(px.numpy()[16 * k:16 * (k + 1)]),
                                         jnp.asarray(py.numpy()[16 * k:16 * (k + 1)]),
                                         int(seeds[k]), 2))
        np.testing.assert_array_equal(got[16 * k:16 * (k + 1)].view(np.int32),
                                      want.view(np.int32))
