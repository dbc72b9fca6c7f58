"""The zoo and the courtyard rasterized on the card against the same frames
on the CPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_raster_blend_cuda.py -q

Without a CUDA device every test here skips (the traversal and tile
kernels have no CPU mode). `bench_scene.build_raster_scene` builds each
scene on both devices (diffuse prefilter 16 on both) and `raster_step`
draws it at 64x48 in both visibilities: the zoo's blend pass over its
backdrop pyramid and its clearcoat IBL, the courtyard's masked retry. The
kernels are bit-identical to their plain versions; the shading differs in
the last bits (CUDA's sin, cos, pow and exp), so frames are held at the
raster CPU tests' bar (tests/test_torch_raster_frame.py): at least 99.5% of
pixels within 1e-4 + 1e-3 relative, the means within 0.1%.
"""

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch.bench_scene import build_raster_scene
from gltf_renderer_tpu_torch.ops import raster
from gltf_renderer_tpu_torch.ops import traverse as tr
from gltf_renderer_tpu_torch.render import renderer

pytestmark = pytest.mark.cuda
RES = (64, 48)
DIFFUSE_SIZE = 16


@pytest.fixture(scope="module", params=["materials", "courtyard"])
def built(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the traversal and tile kernels have no CPU mode)")
    return {dev: build_raster_scene(request.param, *RES, device=dev, diffuse_size=DIFFUSE_SIZE)
            for dev in ("cpu", "cuda")}


@pytest.mark.parametrize("vis", ["raycast", "tiled"])
def test_raster_frame_on_the_card_matches_the_cpu(built, vis):
    imgs = {}
    for dev, b in built.items():
        launches = (tr.KERNEL_LAUNCHES, raster.KERNEL_LAUNCHES)
        hdr = renderer.raster_step(*b, 0, visibility=vis)
        assert bool(torch.isfinite(hdr).all())
        k1 = tr.KERNEL_LAUNCHES > launches[0]
        k2 = raster.KERNEL_LAUNCHES > launches[1]
        if dev == "cpu":
            assert not (k1 or k2)
        else:
            assert k2 == (vis == "tiled") and (k1 or vis == "tiled")
        imgs[dev] = hdr.cpu().numpy()
    got, want = imgs["cuda"], imgs["cpu"]
    close = (np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)).all(-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())
