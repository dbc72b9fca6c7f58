"""Windowed SSIM (Wang et al. 2004) — the repo's fidelity metric.

The north-star metric is >=0.99 SSIM vs the DXR reference at equal spp
(BASELINE.json). This is the standard gaussian-windowed SSIM (11x11 window,
sigma 1.5 by default), computed per channel and averaged — NOT the single
global window of early cross-validation tests, which hides local structure
errors entirely.

Pure numpy: it is a test/bench metric, not a render-path op. A copy of
gltf_renderer_tpu/utils/ssim.py, so the port's checks need nothing of the
JAX package.
"""

from __future__ import annotations

import numpy as np


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Separable 'valid' gaussian filtering along the two leading axes."""
    out = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="valid"), 0, img)
    out = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="valid"), 1, out)
    return out


def ssim(a, b, data_range: float = None, window: int = 11, sigma: float = 1.5):
    """Mean SSIM between two (H, W) or (H, W, C) images.

    data_range defaults to 1.0 for float inputs and 255 for uint8.
    The window shrinks (to an odd size) when the image is smaller than 11.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if data_range is None:
        data_range = 255.0 if a.dtype == np.uint8 else 1.0
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    h, w = a.shape[:2]
    win = min(window, h, w)
    if win % 2 == 0:
        win -= 1
    if win < 1:
        raise ValueError("image too small for SSIM")
    kernel = _gaussian_kernel(win, sigma)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(a.shape[2]):
        x = a[..., c]
        y = b[..., c]
        mu_x = _filter2(x, kernel)
        mu_y = _filter2(y, kernel)
        xx = _filter2(x * x, kernel) - mu_x * mu_x
        yy = _filter2(y * y, kernel) - mu_y * mu_y
        xy = _filter2(x * y, kernel) - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * xy + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (xx + yy + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))
