"""BASELINE config 5 with the hit-attribute rows rounded to bf16, as the
JAX package stores them for scenes above 32,768 triangles (its
GLTF_TPU_BF16ROWS "auto", scene/flatten.py), which is how it drew
docs/artifacts/config5_courtyard.png. A study of where the port's
converged image departs from that artifact, not a render path: the port
keeps the rows in f32, as the JAX package does with GLTF_TPU_BF16ROWS=0.

    python -m gltf_renderer_tpu_torch.tools.config5_bf16_rows [--frames 1024]
        [--ckpt-every 32] [--out build/config5_torch_bf16rows]

It runs tools.render_config5 (the same scene, settings, sky, camera,
loop, checkpoints and resume) with every world the Renderer builds
passed through `round_rows`: each vertex's normal, tangent, UVs and
colour in `tri_attr_rows` rounded to bf16 and back. Positions stay f32:
the JAX package rebuilds a hit's position from the ray (origin + t *
direction) when its rows are bf16, which the f32 positions give too.
Hold the result against the artifact with tools.compare_config5 --out.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROW = 20        # floats a vertex in tri_attr_rows: pos3 nrm3 tan4 uv0_2 uv1_2 col4 pad2
ROUNDED = (3, ROW)  # the columns of a vertex's block the JAX package's bf16 rows round


def round_rows(world):
    """`world` (a flatten.WorldGeometry) with the three vertex blocks of
    tri_attr_rows rounded to bf16 past their positions (round to nearest
    even, as the JAX package's astype), on the rows' own device and type."""
    rows = world.tri_attr_rows
    as_numpy = isinstance(rows, np.ndarray)
    out = torch.as_tensor(rows).clone()
    for k in range(0, 3 * ROW, ROW):
        cols = slice(k + ROUNDED[0], k + ROUNDED[1])
        out[:, cols] = out[:, cols].to(torch.bfloat16).to(torch.float32)
    return world._replace(tri_attr_rows=out.numpy() if as_numpy else out)


def main(argv=None, device="cuda") -> int:
    from gltf_renderer_tpu_torch.scene import flatten
    from gltf_renderer_tpu_torch.tools import render_config5

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--out" not in argv:
        argv += ["--out", os.path.join("build", "config5_torch_bf16rows")]
    build = flatten.build_world_geometry
    flatten.build_world_geometry = lambda *a, **kw: round_rows(build(*a, **kw))
    try:
        return render_config5.main(argv, device=device)
    finally:
        flatten.build_world_geometry = build


if __name__ == "__main__":
    sys.exit(main())
