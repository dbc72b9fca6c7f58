"""Cameras and controllers (numpy, row-major, reversed Z, Z-up world).

A copy of gltf_renderer_tpu/camera.py (Camera.h + CameraController.h):
the projections, `Camera`, `OrbitController` and `FreeController` give the
same f32 matrices bit for bit. The free functions `clip_to_world`,
`world_to_clip` and `position` serve the scripted cameras of the bench,
the tools and chip_smoke; the first and last are `Camera`'s methods.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def perspective_reversed_z(y_fov: float, aspect: float, z_near: float,
                           z_far: float = 0.0) -> np.ndarray:
    """glm::perspectiveRH_ZO(y_fov, aspect, z_far, z_near) (Camera.h:84-91);
    z_far == 0 means infinite, clamped to 1e5."""
    if z_far == 0.0:
        z_far = 100000.0
    t = np.tan(0.5 * y_fov)
    n, f = z_far, z_near
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = f / (n - f)
    m[2, 3] = -(f * n) / (f - n)
    m[3, 2] = -1.0
    return m


def orthographic_reversed_z(x_mag: float, y_mag: float, z_near: float,
                            z_far: float) -> np.ndarray:
    """glm::orthoRH_ZO(-1/x_mag, 1/x_mag, -1/y_mag, 1/y_mag, z_far, z_near)
    (Camera.h:93, near and far swapped)."""
    l, r = -1.0 / x_mag, 1.0 / x_mag
    b, t = -1.0 / y_mag, 1.0 / y_mag
    n, f = z_far, z_near
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (r - l)
    m[1, 1] = 2.0 / (t - b)
    m[2, 2] = -1.0 / (f - n)
    m[0, 3] = -(r + l) / (r - l)
    m[1, 3] = -(t + b) / (t - b)
    m[2, 3] = -n / (f - n)
    return m


@dataclasses.dataclass
class Camera:
    """Camera.h:6-105."""

    type: str = "perspective"
    y_fov: float = np.pi / 3
    aspect_ratio: float = 16 / 9
    z_near: float = 0.1
    z_far: float = 0.0
    x_mag: float = 1.0
    y_mag: float = 1.0
    world_to_view: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))

    def view_to_clip(self) -> np.ndarray:
        if self.type == "perspective":
            return perspective_reversed_z(self.y_fov, self.aspect_ratio, self.z_near, self.z_far)
        return orthographic_reversed_z(self.x_mag, self.y_mag, self.z_near, self.z_far)

    def world_to_clip(self) -> np.ndarray:
        return self.view_to_clip() @ self.world_to_view

    def clip_to_world(self) -> np.ndarray:
        return np.linalg.inv(self.world_to_clip()).astype(np.float32)

    def position(self) -> np.ndarray:
        return np.linalg.inv(self.world_to_view)[:3, 3].astype(np.float32)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float32)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


def _translate(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


# View basis of both controllers: columns (1,0,0), (0,0,-1), (0,1,0).
_BASIS = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)


@dataclasses.dataclass
class OrbitController:
    """CameraController.h:9-122 (azimuth about Z, inclination about X)."""

    centre: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    radius: float = 1.0
    azimuth: float = 0.0
    inclination: float = 0.0
    min_inclination: float = -0.25 * 2 * np.pi
    max_inclination: float = 0.25 * 2 * np.pi

    def rotate(self, azimuth: float, inclination: float):
        self.azimuth += azimuth
        self.inclination = float(
            np.clip(self.inclination + inclination, self.min_inclination, self.max_inclination))

    def zoom(self, delta: float):
        self.radius = max(self.radius + delta, 0.0)

    def pan(self, x: float, y: float):
        rot = _rot_x(self.inclination) @ _rot_z(self.azimuth)
        right = rot[:3, :3] @ np.array([1.0, 0.0, 0.0], np.float32)
        forward = rot[:3, :3] @ np.array([0.0, 1.0, 0.0], np.float32)
        up = np.cross(right, forward)
        self.centre = self.centre + self.radius * (x * right + y * up)

    def world_to_view(self) -> np.ndarray:
        """CameraController.h:42-49: basis * translate(0, radius, 0) *
        eulerXZ(-inclination, -azimuth) * translate(-centre)."""
        m = _BASIS @ _translate([0.0, self.radius, 0.0])
        m = m @ (_rot_x(-self.inclination) @ _rot_z(-self.azimuth))
        return m @ _translate(-np.asarray(self.centre, np.float32))


@dataclasses.dataclass
class FreeController:
    """CameraController.h:124-243, the WASD + QE fly camera."""

    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    azimuth: float = 0.0
    inclination: float = 0.0
    speed: float = 1.0        # movement_speed (CameraController.h:243)
    fast_factor: float = 2.0  # LSHIFT boost (fast_movement_factor, :244)

    def rotate(self, azimuth: float, inclination: float):
        self.azimuth += azimuth
        self.inclination = float(np.clip(self.inclination + inclination, -np.pi / 2, np.pi / 2))

    def increase_speed(self, delta: float):
        """Mouse-wheel speed adjust (CameraController.h:153-157)."""
        self.speed = max(self.speed + delta, 0.0)

    def move(self, forward: float, right: float, up: float, dt: float, fast: bool = False):
        """Tick + Move (CameraController.h:141-146, :202-227): the local
        direction (right, forward, up) rides eulerZX into world space. The
        reference normalises only when some component is positive (its
        glm::greaterThan(vec3(0)) quirk), so a backward-left diagonal runs
        sqrt(2) fast, here too."""
        v = np.array([right, forward, up], np.float32)
        if (v > 0).any():
            n = float(np.linalg.norm(v))
            if n > 0:
                v = v / n
        rot = (_rot_z(self.azimuth) @ _rot_x(self.inclination))[:3, :3]
        speed = self.speed * (self.fast_factor if fast else 1.0)
        self.position = self.position + speed * dt * (rot @ v)

    def world_to_view(self) -> np.ndarray:
        m = _BASIS @ (_rot_x(-self.inclination) @ _rot_z(-self.azimuth))
        return m @ _translate(-np.asarray(self.position, np.float32))


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """world_to_view for a scripted camera (Z-up)."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m.astype(np.float32)


def clip_to_world(world_to_view: np.ndarray, y_fov: float, aspect: float,
                  z_near: float, z_far: float = 0.0) -> np.ndarray:
    """Camera.clip_to_world of a perspective camera."""
    return Camera(y_fov=y_fov, aspect_ratio=aspect, z_near=z_near, z_far=z_far,
                  world_to_view=world_to_view).clip_to_world()


def world_to_clip(clip_to_world) -> np.ndarray:
    """The f32 inverse of clip_to_world: the matrix the tiled rasterizer
    projects with (the JAX raster backend inverts in f32 too)."""
    return np.linalg.inv(np.asarray(clip_to_world, np.float32)).astype(np.float32)


def position(world_to_view: np.ndarray) -> np.ndarray:
    """Camera.position: the translation of inverse(world_to_view)."""
    return Camera(world_to_view=world_to_view).position()
