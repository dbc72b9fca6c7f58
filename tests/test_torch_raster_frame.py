"""The torch port's raster frame as a whole, against the JAX package.

- `raster_step` in both visibilities against the JAX package's
  `_raster_step` (rasterizer.render, the tiled kernel in interpret mode) on
  the helmet-raster scene at 128x72, both packages reading the same tables
  (convert.from_jax_pt_scene). HDR pixels agree to 1e-4 absolute plus 1e-3
  relative on at least 99.5% of pixels, and the image means to 0.1%. The
  remaining pixels lie on the sphere's silhouette or on a triangle edge,
  where the last bits of the camera matrix product, the f32 inverse and
  XLA:CPU's fused multiply-adds can hand the pixel to another triangle or
  to the background (measured: 0 of 9,216 raycast pixels, 0 tiled).
- `post_step` against `_post_step` on the same HDR image: the u8 frames
  agree within 1 on every pixel, and exactly on at least 99% (AgX runs
  through log2 and pow, whose last bits can cross a rounding boundary;
  measured: 1 of 27,648 channel values off by one).
- The whole port through its Renderer (`helmet_raster_renderer`: the
  port's GLB writer and loader, under the port's environment build with a
  16-texel diffuse prefilter to keep the CPU build short), in both
  visibilities against the committed CPU golden tests/goldens/helmet_raster.png
  at the golden test's SSIM bar of 0.99.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu_torch.bench_scene import raster_camera
from gltf_renderer_tpu_torch.ops import raster as praster
from gltf_renderer_tpu_torch.ops import traverse as ptr
from gltf_renderer_tpu_torch.render import renderer as prend
from gltf_renderer_tpu_torch.render import settings as PS
from tests.test_torch_raster_shading import build_jax_raster_scene

torch.set_num_threads(2)
RES = (128, 72)
EYE = [1.2, -1.2, 0.8]  # the helmet-raster golden camera


@pytest.fixture(scope="module")
def frame_case(tmp_path_factory):
    """Scenes of both packages and the JAX HDR frames in both visibilities."""
    from gltf_renderer_tpu.render import renderer as jrend
    from gltf_renderer_tpu.render import settings as JS

    jscene, jmeta, pscene, pmeta = build_jax_raster_scene(str(tmp_path_factory.mktemp("frame")))
    c2w, cam_pos = raster_camera(EYE, *RES)
    rs = JS.RenderSettings(backend="rasterizer", width=RES[0], height=RES[1])
    want = {vis: np.asarray(jrend._raster_step(jscene, jmeta, rs, JS.PathTracerParams(),
                                               jnp.asarray(c2w), jnp.asarray(cam_pos), RES,
                                               jnp.uint32(0), vis))
            for vis in ("raycast", "tiled")}
    return pscene, pmeta, c2w, cam_pos, want


@pytest.mark.parametrize("vis", ["raycast", "tiled"])
def test_raster_step_matches_jax(frame_case, vis):
    pscene, pmeta, c2w, cam_pos, want = frame_case
    rs = PS.RenderSettings(backend="rasterizer", width=RES[0], height=RES[1])
    calls = (ptr.REFERENCE_CALLS, praster.REFERENCE_CALLS)
    got = prend.raster_step(pscene, pmeta, rs, PS.PathTracerParams(), c2w, cam_pos, RES, 0,
                            visibility=vis).numpy()
    # CPU tensors run the plain versions: one traversal chunk, or one tile pass.
    expect = (calls[0] + 1, calls[1]) if vis == "raycast" else (calls[0], calls[1] + 1)
    assert (ptr.REFERENCE_CALLS, praster.REFERENCE_CALLS) == expect
    assert got.shape == (RES[1], RES[0], 3) and np.isfinite(got).all()
    w = want[vis]
    close = (np.abs(got - w) <= 1e-4 + 1e-3 * np.abs(w)).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(got.mean() - w.mean()) <= 1e-3 * w.mean()


def test_post_step_matches_jax(frame_case):
    from gltf_renderer_tpu.render import renderer as jrend
    from gltf_renderer_tpu.render import settings as JS

    hdr = frame_case[4]["raycast"]
    jrs = JS.RenderSettings()
    prs = PS.RenderSettings()
    got = {}
    for frame in (0, 7):
        want = np.asarray(jrend._post_step(jnp.asarray(hdr), jrs.tonemap, jrs.bloom,
                                           jnp.uint32(frame)))
        got[frame] = prend.post_step(torch.tensor(hdr), prs.tonemap, prs.bloom,
                                     frame).numpy()
        assert got[frame].dtype == np.uint8 and got[frame].shape == want.shape
        diff = np.abs(got[frame].astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.99, (diff == 0).mean()
    assert not np.array_equal(got[0], got[7])  # the dither follows the frame
    no_bloom = prend.post_step(torch.tensor(hdr), prs.tonemap,
                               PS.BloomSettings(enabled=False), 0).numpy()
    assert not np.array_equal(no_bloom, got[0])


@pytest.mark.parametrize("vis", ["raycast", "tiled"])
def test_port_built_frame_matches_golden(vis):
    """The helmet-raster golden configuration through the port's Renderer
    (the port's GLB writer, loader and environment build) -> u8 frame,
    against the CPU golden."""
    from PIL import Image

    from gltf_renderer_tpu_torch.bench_scene import analytic_equirect, helmet_raster_renderer
    from gltf_renderer_tpu_torch.env.environment import build_environment
    from gltf_renderer_tpu_torch.utils.ssim import ssim
    from tests.golden_configs import GOLDEN_DIR

    r = helmet_raster_renderer("cpu", build_environment(analytic_equirect(), device="cpu",
                                                        diffuse_size=16))
    r.raster_visibility = vis
    img = r.draw_frame()
    golden = np.asarray(Image.open(f"{GOLDEN_DIR}/helmet_raster.png"))
    assert img.shape == golden.shape
    assert ssim(img, golden) >= 0.99
