"""The port's cameras (gltf_renderer_tpu_torch/camera.py) against the JAX
package's camera.py, bit for bit: the two reversed-Z projections, `Camera`
of both types, `OrbitController` (rotate with its inclination clamp, zoom
clamped at 0, pan) and `FreeController` (rotate, increase_speed, move in
every key direction, the backward-left greaterThan quirk and the fast
factor), on parameters drawn from a seeded numpy generator. Host numpy
only; no device."""

import numpy as np
import pytest

from gltf_renderer_tpu import camera as jcam
from gltf_renderer_tpu_torch import camera as pcam

SEEDS = [0, 1, 2, 3]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (a, b)


def _lens(rng):
    return dict(y_fov=float(rng.uniform(0.2, 2.5)), aspect=float(rng.uniform(0.3, 3.0)),
                z_near=float(rng.uniform(1e-3, 1.0)), z_far=float(rng.choice([0.0, 50.0, 1e4])))


def _view(rng):
    eye = rng.uniform(-10, 10, 3)
    return jcam.look_at(eye, eye + rng.uniform(-1, 1, 3) + [0.0, 0.0, 0.01])


@pytest.mark.parametrize("kind", ["perspective", "orthographic"])
@pytest.mark.parametrize("seed", SEEDS)
def test_projection_matches_jax(kind, seed):
    rng = np.random.default_rng(seed)
    for z_far in (0.0, float(rng.uniform(5.0, 500.0))):
        z_near = float(rng.uniform(1e-3, 1.0))
        if kind == "perspective":
            args = (float(rng.uniform(0.2, 2.5)), float(rng.uniform(0.3, 3.0)), z_near, z_far)
            _same(pcam.perspective_reversed_z(*args), jcam.perspective_reversed_z(*args))
        else:
            args = (float(rng.uniform(0.05, 4.0)), float(rng.uniform(0.05, 4.0)), z_near, z_far)
            _same(pcam.orthographic_reversed_z(*args), jcam.orthographic_reversed_z(*args))


@pytest.mark.parametrize("kind", ["perspective", "orthographic"])
@pytest.mark.parametrize("seed", SEEDS)
def test_camera_matches_jax(kind, seed):
    rng = np.random.default_rng(100 + seed)
    lens = _lens(rng)
    kw = dict(type=kind, y_fov=lens["y_fov"], aspect_ratio=lens["aspect"],
              z_near=lens["z_near"], z_far=lens["z_far"], x_mag=float(rng.uniform(0.1, 3)),
              y_mag=float(rng.uniform(0.1, 3)), world_to_view=_view(rng))
    p, j = pcam.Camera(**kw), jcam.Camera(**kw)
    for method in ("view_to_clip", "world_to_clip", "clip_to_world", "position"):
        _same(getattr(p, method)(), getattr(j, method)())
    d_p, d_j = pcam.Camera(), jcam.Camera()
    _same(d_p.clip_to_world(), d_j.clip_to_world())
    assert (d_p.type, d_p.y_fov, d_p.aspect_ratio, d_p.z_near, d_p.z_far) == (
        d_j.type, d_j.y_fov, d_j.aspect_ratio, d_j.z_near, d_j.z_far)


@pytest.mark.parametrize("seed", SEEDS)
def test_free_functions_are_the_camera_methods(seed):
    """clip_to_world and position (the scripted cameras' helpers) equal the
    JAX Camera's matrices; look_at equals JAX's."""
    rng = np.random.default_rng(200 + seed)
    eye, target = rng.uniform(-5, 5, 3), rng.uniform(-1, 1, 3)
    w2v = pcam.look_at(eye, target)
    _same(w2v, jcam.look_at(eye, target))
    lens = _lens(rng)
    j = jcam.Camera(y_fov=lens["y_fov"], aspect_ratio=lens["aspect"], z_near=lens["z_near"],
                    z_far=lens["z_far"], world_to_view=w2v)
    _same(pcam.clip_to_world(w2v, lens["y_fov"], lens["aspect"], lens["z_near"],
                             lens["z_far"]), j.clip_to_world())
    _same(pcam.position(w2v), j.position())


def _orbit_state(c):
    return (np.asarray(c.centre), c.radius, c.azimuth, c.inclination, c.world_to_view())


@pytest.mark.parametrize("seed", SEEDS)
def test_orbit_controller_matches_jax(seed):
    rng = np.random.default_rng(300 + seed)
    kw = dict(centre=rng.uniform(-3, 3, 3).astype(np.float32), radius=float(rng.uniform(0.5, 9)),
              azimuth=float(rng.uniform(-3, 3)), inclination=float(rng.uniform(-1, 1)))
    p, j = pcam.OrbitController(**kw), jcam.OrbitController(**kw)
    clamped = zoomed_to_zero = False
    for step in range(24):
        op = step % 3
        if op == 0:  # big inclination steps reach both clamps
            a, b = float(rng.uniform(-2, 2)), float(rng.uniform(-2.5, 2.5))
            p.rotate(a, b)
            j.rotate(a, b)
            clamped |= abs(abs(p.inclination) - 0.5 * np.pi) < 1e-12
        elif op == 1:
            dz = float(rng.uniform(-12, 6))
            p.zoom(dz)
            j.zoom(dz)
            zoomed_to_zero |= p.radius == 0.0
        else:
            x, y = float(rng.uniform(-2, 2)), float(rng.uniform(-2, 2))
            p.pan(x, y)
            j.pan(x, y)
        for a, b in zip(_orbit_state(p), _orbit_state(j)):
            _same(a, b)
    assert clamped and zoomed_to_zero


KEYS = [(f, r, u) for f in (-1, 0, 1) for r in (-1, 0, 1) for u in (-1, 0, 1)]


@pytest.mark.parametrize("seed", SEEDS)
def test_free_controller_matches_jax(seed):
    rng = np.random.default_rng(400 + seed)
    kw = dict(position=rng.uniform(-5, 5, 3).astype(np.float32),
              azimuth=float(rng.uniform(-3, 3)), inclination=float(rng.uniform(-1, 1)))
    p, j = pcam.FreeController(**kw), jcam.FreeController(**kw)
    for i, (f, r, u) in enumerate(KEYS):
        a, b = float(rng.uniform(-1.5, 1.5)), float(rng.uniform(-2, 2))
        p.rotate(a, b)
        j.rotate(a, b)
        ds = float(rng.uniform(-1.5, 1.0))
        p.increase_speed(ds)
        j.increase_speed(ds)
        dt, fast = float(rng.uniform(0.01, 0.5)), bool(i % 2)
        p.move(f, r, u, dt, fast=fast)
        j.move(f, r, u, dt, fast=fast)
        for x, y in ((p.position, j.position), (p.azimuth, j.azimuth),
                     (p.inclination, j.inclination), (p.speed, j.speed),
                     (p.world_to_view(), j.world_to_view())):
            _same(x, y)


def test_free_controller_backward_left_quirk():
    """No component positive: the direction is not normalised, so the
    backward-left diagonal moves sqrt(2) x speed x dt, in both packages."""
    for mod in (pcam, jcam):
        c = mod.FreeController()
        c.move(forward=-1, right=-1, up=0, dt=1.0)
        assert np.isclose(np.linalg.norm(c.position), np.sqrt(2.0))
        c = mod.FreeController()
        c.move(forward=1, right=1, up=0, dt=1.0, fast=True)
        assert np.isclose(np.linalg.norm(c.position), 2.0)
