"""The reference's accumulated image at a sample of pixels: the scene and
sky built again from the benchmark's inputs, every frame's sample traced
for the sampled pixels (frames batched into wavefronts of at most
`block` lanes), the running mean taken frame by frame in the renderer's
arithmetic, and the u8 frame of the last one.

The harness calls a reference package only through this module's
`settings`, `build_scene`, `accumulate` and `frame_u8` (perfbench/spec.py
`reference`)."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import bvh, env, post
from . import pathtracer, world


def settings(pt: dict) -> pathtracer.Settings:
    """The reference's settings from the configuration's whole `pt` dict:
    the bounces, the luminance clamp, environment NEE (environment_map and
    environment_mis) and punctual-light NEE (point_lights), each with the
    renderer's default where the dict has none. Light shadows are binary,
    so shadow_rays must be on and alpha shadows must not apply."""
    if not pt.get("shadow_rays", True):
        raise ValueError("the reference casts every light's shadow ray (shadow_rays on)")
    return pathtracer.Settings(
        max_bounces=pt["max_bounces"], min_bounces=pt["min_bounces"],
        luminance_clamp=pt.get("luminance_clamp_enabled", True),
        env_nee=pt.get("environment_map", True) and pt.get("environment_mis", True),
        light_nee=pt.get("point_lights", True))


def build_scene(scene: dict, sky: np.ndarray, device, control: bool = False):
    w = world.build_world(scene, device)
    if control:
        w = pathtracer.round_rows_bf16(w)
    mats = world.build_materials(scene, device)
    return pathtracer.Scene(
        world=w, tree=bvh.build(w.p0, w.p1, w.p2, device), materials=mats,
        textures=world.build_textures(scene, device), env=env.build(sky, device),
        has_masked=bool((mats.alpha_mode == world.MASK).any()),
        lights=world.build_lights(scene, device), sheen_e=pathtracer.load_sheen_e(device))


def accumulate(ref: pathtracer.Scene, settings: pathtracer.Settings, c2w: np.ndarray,
               resolution, px: np.ndarray, py: np.ndarray, seeds, block: int = 1 << 18):
    """(P, 3) running mean over the frames keyed by `seeds` (in order) at
    pixels (px, py)."""
    dev = ref.world.rows.device
    c2w_t = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
    pxt = torch.as_tensor(np.asarray(px, np.int64), device=dev)
    pyt = torch.as_tensor(np.asarray(py, np.int64), device=dev)
    p = pxt.shape[0]
    per = max(1, block // p)
    acc = None
    k = 0
    for start in range(0, len(seeds), per):
        chunk = seeds[start:start + per]
        f = len(chunk)
        seed_t = torch.as_tensor(np.repeat(np.asarray(chunk, np.int64), p), device=dev)
        rad = pathtracer.trace(ref, settings, c2w_t, resolution, pxt.repeat(f), pyt.repeat(f),
                               seed_t).reshape(f, p, 3)
        for i in range(f):
            if acc is None:
                acc = rad[i]
            else:
                blend = 1.0 / (torch.full((), k, dtype=torch.float32, device=dev) + 1.0)
                acc = acc + (rad[i] - acc) * blend
            k += 1
    return acc


def frame_u8(acc, px, py, frame_index: int):
    dev = acc.device
    return post.u8_frame(acc, torch.as_tensor(np.asarray(px, np.int64), device=dev),
                         torch.as_tensor(np.asarray(py, np.int64), device=dev), frame_index)
