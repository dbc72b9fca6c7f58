"""Perspective camera matrices (numpy, row-major, reversed Z, Z-up world).

The subset of gltf_renderer_tpu/camera.py the bench cameras use.
"""

from __future__ import annotations

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
    """inverse(view_to_clip @ world_to_view) as f32 (Camera.clip_to_world)."""
    view_to_clip = perspective_reversed_z(y_fov, aspect, z_near, z_far)
    return np.linalg.inv(view_to_clip @ world_to_view).astype(np.float32)


def world_to_clip(clip_to_world) -> np.ndarray:
    """The f32 inverse of clip_to_world: the matrix the tiled rasterizer
    projects with (the JAX raster backend inverts in f32 too)."""
    return np.linalg.inv(np.asarray(clip_to_world, np.float32)).astype(np.float32)


def position(world_to_view: np.ndarray) -> np.ndarray:
    """Camera position: the translation of inverse(world_to_view)."""
    return np.linalg.inv(world_to_view)[:3, 3].astype(np.float32)
