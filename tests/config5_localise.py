"""Where the port's config 5 image departs from docs/artifacts/config5_courtyard.png:
a window of the 1920x1080 frame drawn on the CPU by the port and by the
JAX package, with the JAX package's hit-attribute rows in f32 and in bf16.

    JAX_PLATFORMS=cpu python -m tests.config5_localise [--spp 64] [--window X,Y,W,H]
        [--variants port,port_bf16_rows,jax_f32_rows,jax_bf16_rows] [--png PNG ...]

The JAX package stores a scene's per-triangle hit attributes (normals,
tangents, UVs) as bf16 rows above 32,768 triangles (GLTF_TPU_BF16ROWS
"auto", scene/flatten.py), which the courtyard's 273,856 triangles are;
the port keeps them in f32, as the JAX package does with
GLTF_TPU_BF16ROWS=0. The script draws the config 5 view (the tool's
settings, analytic sky and camera; seeds 0..spp-1 accumulated as the
Renderer does, then its tone map) over a window of the 1080p frame at
its own pixel coordinates (WINDOW, 256x144 over the banners and pillars,
by default), in up to four ways: the port, the port
with its rows rounded as tools.config5_bf16_rows rounds them, the JAX
package with f32 rows, and the JAX package with bf16 rows (its default,
which drew the artifact). It prints one JSON object: each pair's SSIM
(utils.ssim over the u8 windows, as the golden checks call it), mean
absolute u8 difference and largest HDR difference, each against the
artifact's window, and each --png (a converged 1080p config 5 image)'s
window against the variants and the artifact. The JAX environment builds
only the tables the path tracer reads. A variant takes ~10 minutes at 64
spp over the default window on a CPU, and about as long at 1,024 spp
over 64x36.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

WINDOW = (240, 270, 256, 144)  # (x, y, w, h) in the 1080p frame, over the banners and pillars
FULL = (1920, 1080)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "docs", "artifacts", "config5_courtyard.png")


def _c2w():
    from gltf_renderer_tpu_torch.bench_scene import COURTYARD_VIEW
    from gltf_renderer_tpu_torch.camera import Camera, look_at

    return Camera(y_fov=np.pi / 3, aspect_ratio=FULL[0] / FULL[1], z_near=0.01,
                  world_to_view=look_at(*COURTYARD_VIEW)).clip_to_world()


def _settings(S):
    return S.PathTracerSettings(max_bounces=2, min_bounces=2, alpha_shadows=True)


def _accumulate(samples):
    """The Renderer's running mean of the (h, w, 3) samples, tone mapped
    and dithered as its last frame is: (u8 window, HDR mean)."""
    import torch

    from gltf_renderer_tpu_torch.post.tonemap import to_u8, tonemap
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import settings as PS

    acc, n = None, 0
    for rad in samples:
        rad = torch.from_numpy(np.array(rad, np.float32))
        acc = pt.accumulate(acc if acc is not None else rad, rad, torch.tensor(n),
                            _settings(PS))
        n += 1
    u8 = to_u8(tonemap(acc, PS.TONEMAPPER_AGX, 1.0, n - 1)).numpy()
    return u8, acc.numpy()


def port_window(glb, sky, spp, window, bf16_rows: bool = False):
    from gltf_renderer_tpu_torch.bench_scene import world_from_scene
    from gltf_renderer_tpu_torch.env.environment import build_environment
    from gltf_renderer_tpu_torch.render import pathtracer as pt
    from gltf_renderer_tpu_torch.render import settings as PS
    from gltf_renderer_tpu_torch.scene.gltf import load_gltf
    from gltf_renderer_tpu_torch.tools.config5_bf16_rows import round_rows

    src = load_gltf(glb)
    world, lights = world_from_scene(src)
    if bf16_rows:
        world = round_rows(world)
    env = build_environment(sky, device="cpu", prefilters=False)
    scene, meta = pt.make_pt_scene(world, src.materials, src.textures, lights, env=env,
                                   device="cpu")
    x, y, w, h = window
    return _accumulate(
        pt.trace(scene, meta, _settings(PS), PS.PathTracerParams(), _c2w(), (w, h), s,
                 pixel_offset=(x, y), full_resolution=FULL) for s in range(spp))


def jax_window(glb, sky, spp, window, bf16_rows: bool):
    import jax
    import jax.numpy as jnp

    from gltf_renderer_tpu.env import environment as E
    from gltf_renderer_tpu.ops import sampling as Sm
    from gltf_renderer_tpu.render import pathtracer as jpt
    from gltf_renderer_tpu.render import settings as JS
    from gltf_renderer_tpu.scene import flatten as jf
    from gltf_renderer_tpu.scene.gltf import load_gltf

    os.environ["GLTF_TPU_BF16ROWS"] = "auto" if bf16_rows else "0"
    os.environ["GLTF_TPU_ENV_CACHE"] = "off"
    src = load_gltf(glb)
    tf = jf.compute_global_transforms(src)
    plan = jf.build_instance_plan(src)
    world = jax.tree.map(np.asarray, jf.build_world_geometry(
        jax.tree.map(jnp.asarray, src.pools), plan, jnp.asarray(tf),
        jnp.asarray(jf.normal_transforms(tf)), jf.plan_tri_flags(plan, src.primitives)))
    want = np.dtype("float32") if not bf16_rows else np.dtype(jnp.bfloat16)
    assert world.tri_attr_rows.dtype == want, world.tri_attr_rows.dtype
    cube = E.build_cube_mips(E.build_cubemap(jnp.asarray(sky), 64))  # its default for 512 wide
    importance = E.build_importance_map(cube[0], cube[1:])
    env = E.EnvMaps(cube=cube, ggx=[], diffuse=None, importance=importance,
                    equirect=jnp.asarray(sky),
                    alias_rows=jnp.asarray(Sm.build_alias_rows(np.asarray(importance[0]))))
    scene, meta = jpt.make_pt_scene(world, src.materials, src.textures,
                                    jf.gather_lights(src, tf), env=env)
    trace = jax.jit(jpt.trace, static_argnums=(1, 2, 5),
                    static_argnames=("pixel_offset", "full_resolution"))
    x, y, w, h = window
    c2w = jnp.asarray(_c2w())
    return _accumulate(
        trace(scene, meta, _settings(JS), JS.PathTracerParams(), c2w, (w, h), jnp.uint32(s),
              pixel_offset=(x, y), full_resolution=FULL) for s in range(spp))


VARIANTS = {
    "port": port_window,
    "port_bf16_rows": lambda *a: port_window(*a, bf16_rows=True),
    "jax_f32_rows": lambda *a: jax_window(*a, bf16_rows=False),
    "jax_bf16_rows": lambda *a: jax_window(*a, bf16_rows=True),
}


def _pair(a, b):
    from gltf_renderer_tpu_torch.utils.ssim import ssim

    return {"ssim": ssim(a, b),
            "mean_abs_u8": float(np.abs(a.astype(np.int16) - b.astype(np.int16)).mean())}


def main(argv=None):
    from PIL import Image

    from gltf_renderer_tpu_torch.bench_scene import analytic_sky
    from gltf_renderer_tpu_torch.scene.procedural import write_courtyard_glb

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--window", default=",".join(map(str, WINDOW)))
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--png", action="append", default=[])
    args = p.parse_args(argv)
    window = tuple(int(v) for v in args.window.split(","))
    x, y, w, h = window
    crop = (slice(y, y + h), slice(x, x + w))
    artifact = np.asarray(Image.open(ARTIFACT).convert("RGB"))[crop]
    sky = analytic_sky(256, 512)
    with tempfile.TemporaryDirectory() as d:
        glb = write_courtyard_glb(os.path.join(d, "courtyard.glb"), density=1)
        got = {name: VARIANTS[name](glb, sky, args.spp, window)
               for name in args.variants.split(",")}
    out = {"window": list(window), "spp": args.spp}
    names = list(got)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            out[f"{a}_vs_{b}"] = _pair(got[a][0], got[b][0])
            out[f"{a}_vs_{b}"]["hdr_max_abs"] = float(np.abs(got[a][1] - got[b][1]).max())
        out[f"{a}_vs_artifact"] = _pair(got[a][0], artifact)
    for path in args.png:
        png = np.asarray(Image.open(path).convert("RGB"))[crop]
        out[f"{path}_vs_artifact"] = _pair(png, artifact)
        for a in names:
            out[f"{path}_vs_{a}"] = _pair(png, got[a][0])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
