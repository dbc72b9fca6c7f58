"""Punctual light sampling (port of gltf_renderer_tpu/ops/lights.py).

GetLightRay (Lights.hlsli:26-61) over a gathered light table: point, spot
and directional lights, the smooth distance-cutoff falloff and the spot
angular attenuation; SamplePointLight's uniform pick
(PathTracer.lib.hlsl:680-686).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from gltf_renderer_tpu_torch.scene.types import LIGHT_TYPE_DIRECTIONAL, LIGHT_TYPE_SPOT
from gltf_renderer_tpu_torch.utils.math import normalize, saturate, sum_last


class LightRay(NamedTuple):
    direction: Any  # (R, 3) unit, surface -> light
    color: Any      # (R, 3) incident radiance after falloff


def get_light_ray(lights, light_index, surface_pos) -> LightRay:
    """lights: GpuLights of tensors; light_index (R,) int; surface_pos (R, 3)."""
    idx = light_index.long()
    lt = lights.type[idx]
    pos = lights.position[idx]
    ldir = lights.direction[idx]
    color = lights.color[idx] * lights.intensity[idx].unsqueeze(-1)
    cutoff = lights.cutoff[idx]

    is_positional = lt != LIGHT_TYPE_DIRECTIONAL
    to_light = torch.where(is_positional.unsqueeze(-1), pos - surface_pos, -ldir)

    dist = torch.sqrt(torch.clamp(sum_last(to_light * to_light), min=1e-20))
    falloff = torch.where(
        cutoff > 0.0,
        torch.clamp(1.0 - (dist / torch.clamp(cutoff, min=1e-20)) ** 4, 0.0, 1.0),
        torch.ones_like(dist))
    falloff = falloff / (dist * dist)
    color = torch.where(is_positional.unsqueeze(-1), color * falloff.unsqueeze(-1), color)

    direction = normalize(to_light)

    # Spot angular attenuation (Lights.hlsli:48-58).
    cos_outer = torch.cos(lights.outer_angle[idx])
    scale = 1.0 / torch.clamp(torch.cos(lights.inner_angle[idx]) - cos_outer, min=1e-3)
    offset = -cos_outer * scale
    cd = -sum_last(normalize(ldir) * direction)
    ang = saturate(cd * scale + offset)
    ang = ang * ang
    color = torch.where((lt == LIGHT_TYPE_SPOT).unsqueeze(-1), color * ang.unsqueeze(-1), color)
    return LightRay(direction=direction, color=color)


def sample_point_light(lights, num_lights: int, surface_pos, u):
    """Uniform light pick. Returns (LightRay, pdf)."""
    idx = torch.clamp((u * float(num_lights)).to(torch.int32), 0, num_lights - 1)
    return get_light_ray(lights, idx, surface_pos), 1.0 / float(num_lights)
