"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
benchmark's own tests: a few dozen pixels, the small sphere or the
courtyard with 64^2 textures, a 32x64 sky; every pixel checked."""

from __future__ import annotations

import functools

from perfbench import spec

TINY_SCENES = {"textured_sphere": {"tex_size": 64, "n_lat": 16, "n_lon": 32},
               "courtyard": {"tex_size": 64}}


def tiny_cell(workload: str, width: int = 32, height: int = 18, root: str = spec.ROOT):
    cell = spec.load_cell(workload, root)
    cfg = dict(cell.config, width=width, height=height)
    gen = cfg["scene"]["generator"]
    cfg["scene"] = {"generator": gen, "params": dict(cfg["scene"]["params"], **TINY_SCENES[gen])}
    cfg["sky"] = {"generator": cfg["sky"]["generator"], "params": {"h": 32, "w": 64}}
    return cell._replace(config=cfg, limits=dict(cell.limits, pixels=width * height))


def cpu_environment(monkeypatch):
    """The renderer's environment without the raster prefilters, which the
    path tracer never reads and which take minutes on a CPU."""
    from gltf_renderer_tpu_torch.env.environment import build_environment
    from gltf_renderer_tpu_torch.render import renderer

    monkeypatch.setattr(renderer, "build_environment",
                        functools.partial(build_environment, prefilters=False))
