"""The one traffic generator: a closed loop of frames with one client and
a still camera, so the renderer keeps accumulating.

A mix file (perfbench/traffic/<name>.json) gives:
  warm_frames  frames drawn in set-up, before the window;
  seed_stride  frame i is drawn with seed (s0 + i * stride) mod 2^32, s0
               the low 32 bits of splitmix64(--seed).
The next frame is drawn when the previous frame's u8 image has arrived.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


def splitmix64(x: int) -> int:
    z = (int(x) + 0x9E3779B97F4A7C15) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.warm_frames = int(mix["warm_frames"])
        self.stride = int(mix["seed_stride"])
        self.s0 = splitmix64(seed) & M32

    def frame_seed(self, i: int) -> int:
        return (self.s0 + i * self.stride) & M32
