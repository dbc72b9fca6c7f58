"""Torch port post chain (post/bloom.py, post/tonemap.py) vs the JAX package.

Seeded HDR images (a dim base with a few bright spots, values up to 60) at
even, odd and degenerate sizes go through both packages:

Sizes: even, odd, the raster fidelity frame's 192x108, and 17x33 whose
deepest mip is one texel tall.

- the bloom mip chain and composite agree to 1e-6 relative to the image's
  largest value: the port sums each fixed stencil's taps in its own order,
  XLA's convolution in another, and nothing else differs (the largest
  measured difference is a few f32 ulps of the brightest value);
- AgX, sRGB encode and the dither agree to 1e-5 absolute on display values
  in [0, 1]: log2 and pow differ in the last bits between XLA and torch, and
  the AgX polynomial and the 2.2 power magnify that (measured 4.1e-6 on 2
  of 27,648 values);
  the dither noise itself is bit-exact (pcg3d on integers);
- to_u8 of the same display values is equal exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.post import bloom as jbloom
from gltf_renderer_tpu.post import tonemap as jtone
from gltf_renderer_tpu_torch.post import bloom as pbloom
from gltf_renderer_tpu_torch.post import tonemap as ptone
from gltf_renderer_tpu_torch.render import settings as PS

torch.set_num_threads(2)
SIZES = [(72, 128), (27, 45), (108, 192), (17, 33)]


def _hdr(h, w, seed):
    rs = np.random.default_rng(seed)
    img = rs.random((h, w, 3)).astype(np.float32) * 0.8
    spots = rs.integers(0, h * w, max(1, h * w // 200))
    img.reshape(-1, 3)[spots] += rs.uniform(5.0, 60.0, (spots.size, 1)).astype(np.float32)
    return img


@pytest.mark.parametrize("h,w", SIZES)
def test_bloom_matches_jax(h, w):
    img = _hdr(h, w, seed=h * 1000 + w)
    want = np.asarray(jbloom.bloom(jnp.asarray(img), 4, 0.01))
    got = pbloom.bloom(torch.from_numpy(img), 4, 0.01).numpy()
    assert got.shape == img.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), np.abs(got - want).max()
    assert np.abs(got - img).max() > 1e-3  # the blur reached the image


@pytest.mark.parametrize("h,w", SIZES[:2])
def test_bloom_stages_match_jax(h, w):
    """Each stage on its own: the 2x downsample and the tent upsample."""
    img = _hdr(h, w, seed=3)
    down_j = np.asarray(jbloom.downsample(jnp.asarray(img), h // 2, w // 2))
    down_p = pbloom._downsample_p(torch.from_numpy(img).permute(2, 0, 1), h // 2,
                                  w // 2).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(down_p, down_j, rtol=0, atol=1e-6 * np.abs(down_j).max())
    up_j = np.asarray(jbloom.upsample_tent(jnp.asarray(down_j), h, w))
    up_p = pbloom._upsample_tent_p(torch.tensor(down_j).permute(2, 0, 1), h,
                                   w).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(up_p, up_j, rtol=0, atol=1e-6 * np.abs(up_j).max())


def test_bloom_refuses_frames_smaller_than_its_chain():
    with pytest.raises(ValueError):
        pbloom.bloom(torch.zeros(9, 40, 3), 4, 0.01)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("frame", [0, 5])
def test_tonemap_matches_jax(h, w, frame):
    img = _hdr(h, w, seed=w)
    want = np.asarray(jtone.tonemap(jnp.asarray(img), PS.TONEMAPPER_AGX, 1.0, frame))
    got = ptone.tonemap(torch.from_numpy(img), PS.TONEMAPPER_AGX, 1.0, frame).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ptone.to_u8(torch.from_numpy(want)).numpy(),
                                  np.asarray(jtone.to_u8(jnp.asarray(want))))


def test_tonemap_none_and_exposure():
    img = _hdr(16, 24, seed=9)
    want = np.asarray(jtone.tonemap(jnp.asarray(img), PS.TONEMAPPER_NONE, 0.5, 3,
                                    apply_dither=False))
    got = ptone.tonemap(torch.from_numpy(img), PS.TONEMAPPER_NONE, 0.5, 3,
                        apply_dither=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dither_noise_is_bit_exact():
    h, w = 9, 13
    py, px = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    zero = np.zeros((h, w, 3), np.float32)
    for frame in (0, 1, 0xFFFFFFFF):
        want = np.asarray(jtone.dither(jnp.asarray(zero), jnp.asarray(px), jnp.asarray(py),
                                       jnp.uint32(frame)))
        got = ptone.dither(torch.from_numpy(zero), torch.from_numpy(px), torch.from_numpy(py),
                           frame).numpy()
        np.testing.assert_array_equal(got, want)
