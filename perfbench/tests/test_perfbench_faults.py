"""A run of a tiny cell on the CPU, whole but for the chip, is correct;
the same run with the timed path broken underneath is not, for each fault
a one-chip path-traced cell can have; the control (the reference with
bfloat16 hit-attribute rows) fails each cell's limits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import check, harness
from perfbench.reference import pathtracer as ref_pt
from perfbench.tests.tiny import cpu_environment, tiny_cell

SEED = 2 ** 33 + 77


def _run(monkeypatch, workload="helmet.pt_still"):
    """Two warm frames and a window of zero seconds, which draws one."""
    cpu_environment(monkeypatch)
    return harness.run_cell(tiny_cell(workload), SEED, 0, False, device="cpu")[0]


def test_unbroken_run_is_correct(monkeypatch):
    res = _run(monkeypatch)
    assert res["correct"]
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"pt_msamples_per_s", "setup_s"}


def _state_unchanged(monkeypatch):
    """The accumulation step returns its state unchanged after frame one."""
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    orig = pt.accumulate
    monkeypatch.setattr(pt, "accumulate", lambda h, f, n, s: h if int(n) > 0 else orig(h, f, n, s))


def _half_batch(monkeypatch):
    """Half of each chunk's rays traced; the rest get the traced half's mean."""
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    orig = pt._trace_rays

    def half(scene, meta, settings, params, c2w, res, seed, px, py, valid=None):
        k = px.shape[0] // 2
        col, st = orig(scene, meta, settings, params, c2w, res, seed, px[:k], py[:k],
                       None if valid is None else valid[:k])
        rest = col.mean(0, keepdim=True).expand(px.shape[0] - k, 3)
        return torch.cat([col, rest]), st

    monkeypatch.setattr(pt, "_trace_rays", half)


def _sample_altered(monkeypatch):
    """Each traced sample's red channel altered where it is produced."""
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    orig = pt._trace_rays

    def altered(*a, **kw):
        col, st = orig(*a, **kw)
        return col * torch.tensor([1.05, 1.0, 1.0]), st

    monkeypatch.setattr(pt, "_trace_rays", altered)


def _frame_altered(monkeypatch):
    """The u8 frame altered where it is produced (tone map and copy)."""
    from gltf_renderer_tpu_torch.render import renderer

    orig = renderer.post_step
    monkeypatch.setattr(renderer, "post_step",
                        lambda *a, **kw: torch.clamp(orig(*a, **kw).int() + 3, 0, 255).byte())


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _sample_altered,
                                   _frame_altered], ids=lambda f: f.__name__.strip("_"))
def test_fault_makes_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    res = _run(monkeypatch)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["courtyard.pt_still", "helmet.pt_still"])
def test_control_fails_the_limits(workload):
    cell = tiny_cell(workload, 48, 27)
    scene, sky = harness.make_inputs(cell)
    cam = cell.config["camera"]
    w2v = ref_pt.look_at(cam["eye"], cam["target"])
    px, py = check.sample_pixels(SEED, 48, 27, 48 * 27)
    seeds = [11, 12, 13, 14]
    nums = harness.reference_numbers(cell, scene, sky, w2v, seeds, 3, px, py, None, None,
                                     "cpu", control=True)
    correct, checks = check.verdict(nums, cell.limits["limits"])
    assert not correct, checks
    assert np.isfinite(list(nums.values())).all()
