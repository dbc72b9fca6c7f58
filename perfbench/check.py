"""How `correct` is decided: the program's accumulated image and u8 frame
at a sample of pixels, against the reference's at the same pixels.

Per sampled pixel, err = max over channels |program - reference| /
(|reference| + 1e-3) of the accumulated mean. Compared numbers:
  accum_err_p50    the median err (a precision or arithmetic change moves
                   every pixel a little);
  accum_err_share  the share of pixels with err > 1e-2 (a fault that breaks
                   some pixels: left out, stale, altered);
  u8_err_share     the share of pixels whose u8 frame differs from the
                   reference's frame of its own mean by more than 1 in
                   some channel (tone map, dither, the copy to the host).
Each has its limit in perfbench/limits/<cell>.json; `correct` is every
number at or under its limit.
"""

from __future__ import annotations

import numpy as np

BAD_PIXEL = 1e-2


def sample_pixels(seed: int, width: int, height: int, n: int):
    """n distinct pixels drawn from the seed: (px, py) int64 arrays."""
    s = int(seed) % (1 << 64)
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, 0x5EED])
    flat = rng.choice(width * height, size=min(n, width * height), replace=False)
    return (flat % width).astype(np.int64), (flat // width).astype(np.int64)


def numbers(prog_acc, prog_u8, ref_acc, ref_u8) -> dict:
    prog_acc = np.asarray(prog_acc, np.float64)
    ref_acc = np.asarray(ref_acc, np.float64)
    err = (np.abs(prog_acc - ref_acc) / (np.abs(ref_acc) + 1e-3)).max(-1)
    err = np.where(np.isfinite(err), err, np.inf)
    du8 = np.abs(np.asarray(prog_u8, np.int64) - np.asarray(ref_u8, np.int64)).max(-1)
    return {"accum_err_p50": float(np.median(err)),
            "accum_err_share": float(np.mean(err > BAD_PIXEL)),
            "u8_err_share": float(np.mean(du8 > 1))}


def verdict(nums: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over every limit of the cell."""
    checks = {k: {"value": nums[k], "limit": float(v)} for k, v in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
