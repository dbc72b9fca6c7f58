"""The material zoo on the card against the same render on the CPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest tests/test_torch_materials_cuda.py -q

Without a CUDA device every test here skips (the traversal kernel has no
CPU mode). The port's `materials_scene` is built on both devices and drawn
at 64x48: the beauty render (2 bounces, seed 3) in the MIS, diffuse-white
and non-MIS modes, and the 28 debug outputs (`render_debug_channels`, one
bounce, seed 5). The card's traversal is bit-identical to the plain
version; the shading differs in the last bits (CUDA's sin, cos, pow and
exp), so images are held at the CPU tests' bar (tests/test_torch_pathtracer.py):
at least 98% of pixels within atol 1e-4 + rtol 1e-3, the means within 1%.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch.bench_scene import (
    N_DEBUG_OUTPUTS,
    build_materials_scene,
    render_debug_channels,
)
from gltf_renderer_tpu_torch.ops import traverse as tr
from gltf_renderer_tpu_torch.render import pathtracer as pt

pytestmark = pytest.mark.cuda
RES = (64, 48)
MODES = {"mis": {}, "diffuse_white": dict(material_diffuse_white=True),
         "no_mis": dict(material_mis=False)}


@pytest.fixture(scope="module")
def zoo():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the traversal kernel has no CPU mode)")
    return {dev: build_materials_scene(*RES, device=dev) for dev in ("cpu", "cuda")}


def _assert_images_match(got, want):
    close = np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)
    assert close.all(-1).mean() >= 0.98, close.all(-1).mean()
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


@pytest.mark.parametrize("mode", list(MODES))
def test_zoo_on_the_card_matches_the_cpu(zoo, mode):
    imgs = {}
    for dev, (scene, meta, settings, params, c2w, _) in zoo.items():
        launches = tr.KERNEL_LAUNCHES
        st = dataclasses.replace(settings, **MODES[mode])
        img, stats = pt.trace(scene, meta, st, params, c2w, RES, 3, with_stats=True)
        assert float(stats[1]) == 0.0 and bool(torch.isfinite(img).all())
        assert (tr.KERNEL_LAUNCHES > launches) == (dev == "cuda")
        imgs[dev] = img.cpu().numpy()
    _assert_images_match(imgs["cuda"], imgs["cpu"])


@pytest.fixture(scope="module")
def channels(zoo):
    return {dev: render_debug_channels(dev).cpu().numpy() for dev in zoo}


@pytest.mark.parametrize("dbg", range(N_DEBUG_OUTPUTS))
def test_debug_channel_on_the_card_matches_the_cpu(channels, dbg):
    got, want = channels["cuda"][dbg], channels["cpu"][dbg]
    assert np.isfinite(got).all()
    _assert_images_match(got, want)
