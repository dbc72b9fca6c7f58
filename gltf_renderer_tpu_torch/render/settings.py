"""Path tracer settings (mirror of gltf_renderer_tpu/render/settings.py).

`PathTracerSettings` holds the static flags the tracer branches on;
`PathTracerParams` the scalars. Defaults are the reference's
(Main.cpp:455-474).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

DEBUG_NONE = 0


@dataclasses.dataclass(frozen=True)
class PathTracerSettings:
    cull_backface: bool = False
    accumulate: bool = True
    luminance_clamp_enabled: bool = True
    indirect_environment_only: bool = False
    point_lights: bool = True
    shadow_rays: bool = True
    alpha_shadows: bool = True
    environment_map: bool = True
    environment_mis: bool = True
    material_diffuse_white: bool = False
    material_use_geometric_normals: bool = False
    material_mis: bool = True
    show_nan: bool = False
    show_inf: bool = False
    shading_normal_adaptation: bool = True
    min_bounces: int = 2
    max_bounces: int = 2
    debug_output: int = DEBUG_NONE


class PathTracerParams(NamedTuple):
    environment_intensity: Any = 1.0
    environment_color: Any = (1.0, 1.0, 1.0)
    luminance_clamp: Any = 20.0
    min_russian_roulette_continue_prob: Any = 0.05
    max_russian_roulette_continue_prob: Any = 0.95
    # Reference quirk kept: Pathtracer.cpp:322 hardcodes 1000.
    max_ray_length: Any = 1000.0
