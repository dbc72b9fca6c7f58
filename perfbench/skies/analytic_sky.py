"""The bench's analytic HDR sky: a sun hotspot (peak ~50) over a gradient,
as an (h, w, 3) f32 equirect, Z up (a frozen copy of the program's
bench_scene.analytic_sky)."""

from __future__ import annotations

import numpy as np


def build(h: int = 256, w: int = 512) -> np.ndarray:
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    z = 1.0 - 2.0 * vv
    phi = 2 * np.pi * uu
    s = np.sqrt(np.maximum(1 - z * z, 0))
    d3 = np.stack([s * np.cos(phi), s * np.sin(phi), z], -1)
    sun = np.asarray([0.5, 0.3, 0.8])
    sun /= np.linalg.norm(sun)
    hotspot = 50.0 * np.maximum((d3 * sun).sum(-1), 0.0) ** 200
    sky = 0.4 + 0.6 * np.maximum(d3[..., 2], 0)
    return np.stack([hotspot + 0.8 * sky, hotspot + 0.85 * sky, hotspot + sky],
                    -1).astype(np.float32)
