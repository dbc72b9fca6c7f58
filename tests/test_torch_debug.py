"""The port's 28 path-tracer debug outputs against the committed goldens.

`bench_scene.render_debug_channels("cpu")` renders every debug output
(PathTracer.lib.hlsl:806-990) on the port's in-memory material zoo at
64x48, one bounce, seed 5, as tests/golden_configs.py::render_debug_channels
does through the JAX renderer, and each channel is held against
tests/goldens/debug_channels.npz at tests/test_debug_goldens.py's bars: the
99.5th percentile of the error relative to max(|golden|, 1) under 5e-3
and its mean under 1e-3 (float16 storage and the CPU backends' rounding;
a wrong attribute, frame or channel moves values at the 1e-1 scale).
Channel 0 (DEBUG_NONE) is the beauty render; 1-21 and 27 are read at the
first hit, 22-26 after the first BSDF sample.
"""

import os

import numpy as np
import pytest
import torch

from gltf_renderer_tpu_torch.bench_scene import N_DEBUG_OUTPUTS, render_debug_channels
from gltf_renderer_tpu_torch.render import settings as S

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "debug_channels.npz")
NAMES = [n for n, _ in sorted(((n, v) for n, v in vars(S).items() if n.startswith("DEBUG_")),
                              key=lambda kv: kv[1])]
assert len(NAMES) == N_DEBUG_OUTPUTS == 28 and NAMES[0] == "DEBUG_NONE"


@pytest.fixture(scope="module")
def rendered():
    return render_debug_channels("cpu").numpy()


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)["channels"].astype(np.float32)


@pytest.mark.parametrize("dbg", range(N_DEBUG_OUTPUTS), ids=NAMES)
def test_debug_channel_matches_golden(rendered, golden, dbg):
    got, want = rendered[dbg], golden[dbg]
    assert got.shape == want.shape
    assert np.isfinite(got).all(), NAMES[dbg]
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert np.percentile(err, 99.5) < 5e-3, (NAMES[dbg], np.percentile(err, 99.5))
    assert err.mean() < 1e-3, (NAMES[dbg], err.mean())
