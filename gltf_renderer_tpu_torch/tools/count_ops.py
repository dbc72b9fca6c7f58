"""The torch ops one path-tracer call issues, by scene.

    python -m gltf_renderer_tpu_torch.tools.count_ops

The path tracer's 1080p steps are host-bound: each ATen op is one host
issue. This counts every ATen op (`TorchDispatchMode`) of one
`trace_chunked` call at spp=4, 2 bounces, on the helmet, the courtyard and
the material zoo at 32x18 (one chunk), on the CPU. A traversal counts as
one op a call, as its kernel launch does on the card: the ops of its plain
version are left out. To count another checkout's package, run this file
by its path with PYTHONPATH set to that checkout. The last line is one JSON
object {scene: {"ops": n, "traversals": k, "chunks": c}}, c the call's
`_trace_rays` calls (pathtracer.RAY_CHUNKS; null for a checkout without it).
"""

from __future__ import annotations

import collections
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gltf_renderer_tpu_torch import bench_scene as bs
from gltf_renderer_tpu_torch.ops import traverse as tr
from gltf_renderer_tpu_torch.render import pathtracer as pt

RES = (32, 18)
SPP = 4
SMALL = dict(tex_size=64, n_lat=16, n_lon=24, sky_hw=(32, 64), cube_size=16)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def count(scene, meta, settings, params, c2w) -> dict:
    """ATen ops of one trace_chunked call, a traversal counted as one."""
    plain = tr.traverse_wide_ref
    calls = 0

    def one_op(*args, **kwargs):
        nonlocal calls
        calls += 1
        with torch.utils._python_dispatch._disable_current_modes():
            return plain(*args, **kwargs)

    chunks_0 = getattr(pt, "RAY_CHUNKS", None)  # checkouts before the counter lack it
    tr.traverse_wide_ref = one_op
    try:
        with _Count() as mode:
            pt.trace_chunked(scene, meta, settings, params, c2w, RES, 1, with_stats=True,
                             spp=SPP)
    finally:
        tr.traverse_wide_ref = plain
    chunks = None if chunks_0 is None else pt.RAY_CHUNKS - chunks_0
    return {"ops": sum(mode.ops.values()) + calls, "traversals": calls, "chunks": chunks}


def main() -> dict:
    out = {}
    for kind in ("helmet", "courtyard"):
        scene, meta, settings, params, c2w, _ = bs.build_bench_scene(*RES, device="cpu",
                                                                     scene_kind=kind, **SMALL)
        out[kind] = count(scene, meta, settings, params, c2w)
    if hasattr(bs, "build_materials_scene"):  # checkouts before the zoo lack it
        scene, meta, settings, params, c2w, _ = bs.build_materials_scene(*RES, device="cpu")
        out["materials"] = count(scene, meta, settings, params, c2w)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
