"""The BVH traversal kernel (csrc/traverse.cu) timed at the kernel table's two launch sizes, on one CUDA card.

    python gltf_renderer_tpu_torch/tools/bench_traverse.py [--root DIR] [--parent SRC] [--rounds N]

On the bench view, at 262,144 primary rays and at 524,288 lane-mixed rays
(closest bounce rays + any-hit env-shadow rays; the ray sets chip_smoke
phase 2 uses), it times in turns (a, b, b, a, ...; CUDA events, 20 calls a
timing):
- `ops.traverse.traverse_wide`, the wrapper the path tracer calls: the time
  the main path pays a launch, and the kernel table's `ms`;
- the kernel's C launcher on ready tensors: the kernel alone;
- with `--parent SRC`, the C launcher of an older traverse.cu, whose hits
  are compared with this kernel's.
Then it times the host microseconds a call of the wrapper and of the
launcher at 1,024 lane rays, where the kernel's work is too small to hide
them. The last line is one JSON object of these numbers.

`--root DIR` imports the package from DIR in place of this checkout, e.g.
an older commit unpacked with `git archive`, so that two commits' wrappers
are timed in one chip call, one process each (parent, change, change,
parent). Run the file by its path for that, not with `python -m`.

`ray_sets`, `launcher`, `time_in_turns` and `host_us` are shared with
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

RAYS_RES = (512, 512)  # 262,144 pixels: the kernel table's primary-ray row
# Integer arguments of traverse_wide_launch by the version its library
# reports (traverse_wide_abi; a library without it is version 1): version 2
# added the tree's stack bound.
ABI_INTS = {1: 5, 2: 6}


def ray_sets(scene, meta, params, c2w, res, device, seed=7):
    """(name, origin, direction, t_min, t_max, mode) sets from the bench
    view: primary rays, bounce-like rays from their hits, and a lane-mixed
    set (closest bounce rays + any-hit env-shadow rays), as the main path
    launches them."""
    from gltf_renderer_tpu_torch.env import environment as env_ops
    from gltf_renderer_tpu_torch.ops import rng
    from gltf_renderer_tpu_torch.ops import sampling
    from gltf_renderer_tpu_torch.render import pathtracer as pt

    w, h = res
    px, py, valid = pt._tile_order(w, h, device)
    jitter = rng.pt_random(px, py, seed, 0)[..., 0:2] - 0.5
    c2w_t = torch.as_tensor(np.asarray(c2w), device=device)
    origin, d_raw = pt.generate_camera_rays(px, py, (w, h), c2w_t, jitter)
    ray_len = torch.sqrt(torch.clamp((d_raw * d_raw).sum(-1), min=1e-20))
    direction = d_raw / ray_len[:, None]
    t_min = torch.where(valid, torch.zeros_like(ray_len), ray_len + 1.0)
    prim = pt.trace_closest(scene, meta, origin, direction, t_min, ray_len)
    attrs = pt.fetch_hit_attributes(scene.world, prim.tri, prim.u, prim.v, direction)
    hit = prim.tri >= 0
    o_b = pt.offset_ray(attrs.position, attrs.geometric_normal)
    d_b = sampling.sample_cosine_hemisphere(attrs.geometric_normal,
                                            rng.pt_random(px, py, seed, 1)[..., 0:2])
    far = torch.full_like(ray_len, params.max_ray_length)
    tmin_b = torch.where(hit, torch.zeros_like(far), far + 1.0)
    d_s, _, _ = env_ops.env_sample(scene.env, rng.pt_random(px, py, seed, 2))
    mode = torch.cat([torch.zeros_like(px), torch.ones_like(px)]).to(torch.int32)
    return [
        ("primary", origin, direction, t_min, ray_len, None),
        ("bounce", o_b, d_b, tmin_b, far, None),
        ("lane_mixed", torch.cat([o_b, o_b]), torch.cat([d_b, d_s]),
         torch.cat([tmin_b, tmin_b]), torch.cat([far, far]), mode),
    ]


def wrapper_args(scene, meta, rays):
    """traverse_wide's positional arguments for the ray set `rays` (cull 0,
    blend 0)."""
    _, o, d, tmn, tmx, mode = rays
    return (scene.wide_nodes, scene.wide_maps.meta, scene.leaf_records, scene.leaf_words,
            o, d, tmn, tmx, meta.wide_root, "lane" if mode is not None else False, 0, 0, mode)


def launcher(lib, scene, meta, rays):
    """A no-argument function that launches the traverse_wide_launch of the
    library `lib` (this kernel's or an older one's, its argument list read
    from traverse_wide_abi) on the ray set `rays` (cull 0, blend 0) into
    fresh outputs, and the outputs (t, word, u, v)."""
    import ctypes

    _, o, d, tmn, tmx, mode = rays
    abi = lib.traverse_wide_abi() if hasattr(lib, "traverse_wide_abi") else 1
    if abi not in ABI_INTS:
        raise RuntimeError(f"traverse_wide_launch version {abi} is not known here")
    ins = [x.contiguous() for x in (scene.wide_nodes, scene.wide_maps.meta, scene.leaf_records,
                                    scene.leaf_words, o, d, tmn, tmx)]
    r = o.shape[0]
    out_t = torch.empty(r, dtype=torch.float32, device=o.device)
    out_u, out_v = torch.empty_like(out_t), torch.empty_like(out_t)
    out_w = torch.empty(r, dtype=torch.int32, device=o.device)
    fn = lib.traverse_wide_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * ABI_INTS[abi]
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    ints = [r, int(meta.wide_root), 2 if mode is not None else 0, 0, 0, int(meta.stack_bound)]
    args = ([x.data_ptr() for x in ins] + [mode.data_ptr() if mode is not None else None]
            + ints[:ABI_INTS[abi]] + [x.data_ptr() for x in (out_t, out_u, out_v, out_w)])

    def run():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(o.get_device()))
        if rc != 0:
            raise RuntimeError(f"traverse_wide_launch failed: CUDA error {rc}")

    return run, (out_t, out_w, out_u, out_v)


def time_in_turns(fns, rounds: int, reps: int = 20):
    """{name: [ms per call, one per round]}: every function timed with CUDA
    events over `reps` calls, the order reversed every other round (a, b,
    b, a, ...), so drift on the card falls on both sides alike."""
    from gltf_renderer_tpu_torch.device import cuda_ms

    names = list(fns)
    times = {n: [] for n in names}
    for rnd in range(rounds):
        for n in (names if rnd % 2 == 0 else names[::-1]):
            times[n].append(cuda_ms(fns[n], reps))
    return times


def host_us(fn, calls=2000):
    """Host microseconds per call of fn() over `calls` calls back to back,
    the queued device work synchronised once at the end."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def identical(a, b):
    """Bit-identical (same shape, same 32-bit words)."""
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def main(device="cuda", parent=None, rounds: int = 4):
    """Time the wrapper, the launcher and (with `parent`, an older
    traverse.cu) the parent's launcher in turns at both sizes, then the
    host cost a call. Returns the numbers as a dict."""
    from gltf_renderer_tpu_torch.bench_scene import build_bench_scene
    from gltf_renderer_tpu_torch.device import card_name_and_power_limit, resolve
    from gltf_renderer_tpu_torch.ops import _build
    from gltf_renderer_tpu_torch.ops import traverse as tr

    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("bench_traverse times a CUDA kernel and needs a CUDA device")
    card = card_name_and_power_limit()
    lib = _build.load("traverse.cu")
    parent_lib = _build.load(os.path.abspath(parent)) if parent else None
    scene, meta, _, params, c2w, _ = build_bench_scene(1920, 1080, device=dev)
    sets = ray_sets(scene, meta, params, c2w, RAYS_RES, dev)
    out = {"package": os.path.dirname(os.path.dirname(os.path.abspath(tr.__file__))),
           "card": card, "stack_bound": int(meta.stack_bound)}
    for rays in (sets[0], sets[2]):
        args = wrapper_args(scene, meta, rays)
        fns, outs = {}, {}
        fns["launcher"], outs["launcher"] = launcher(lib, scene, meta, rays)
        if parent_lib is not None:
            fns["parent_launcher"], outs["parent_launcher"] = launcher(parent_lib, scene, meta,
                                                                       rays)
        fns["wrapper"] = lambda: tr.traverse_wide(*args, stack_bound=meta.stack_bound)
        for f in fns.values():
            f()
        outs["wrapper"] = tr.traverse_wide(*args, stack_bound=meta.stack_bound)
        torch.cuda.synchronize()
        if not all(identical(a, b) for a, b in zip(outs["wrapper"], outs["launcher"])):
            raise AssertionError("the wrapper and its C launcher disagree")
        times = time_in_turns(fns, rounds)
        row = {"n": int(rays[1].shape[0])}
        for name, ms in times.items():
            row[f"{name}_ms"] = ms
            row[f"{name}_ms_median"] = statistics.median(ms)
        if parent_lib is not None:
            p, n = outs["parent_launcher"], outs["launcher"]
            row["parent_t_differs"] = int((p[0].view(torch.int32) != n[0].view(torch.int32)).sum())
            row["parent_words_differ"] = int((p[1] != n[1]).sum())
        out[rays[0]] = row
        print(f"[time] {rays[0]} n={row['n']} " + " ".join(
            f"{k}={[round(x, 5) for x in v]} ms" for k, v in times.items()), flush=True)

    name, o, d, tmn, tmx, mode = sets[2]
    small = (name, o[:1024], d[:1024], tmn[:1024], tmx[:1024], mode[:1024])
    args = wrapper_args(scene, meta, small)
    run, _ = launcher(lib, scene, meta, small)
    out["host_us_1024"] = {
        "wrapper": host_us(lambda: tr.traverse_wide(*args, stack_bound=meta.stack_bound)),
        "launcher": host_us(run)}
    print(f"[host] 1024 lane rays, 2000 calls: wrapper {out['host_us_1024']['wrapper']:.3f} us "
          f"a call, C launcher {out['host_us_1024']['launcher']:.3f} us", flush=True)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="import the package from this directory")
    ap.add_argument("--parent", help="an older traverse.cu whose launcher to time in turns")
    ap.add_argument("--rounds", type=int, default=4)
    a = ap.parse_args()
    if a.root and "gltf_renderer_tpu_torch" in sys.modules:
        sys.exit("--root needs the file run by its path: the package is already imported")
    sys.path.insert(0, os.path.abspath(a.root or os.path.join(os.path.dirname(__file__),
                                                                "..", "..")))
    main(parent=a.parent, rounds=a.rounds)
