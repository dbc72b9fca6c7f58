"""The two hop bounds of the alpha loops, MAX_ALPHA_HOPS = 8 and
MAX_SHADOW_HOPS = 16, pinned in both packages against an unbounded numpy
oracle.

The scene (`scene.procedural.write_alpha_stack_gltf`, read by each
package's loader and built by the JAX package, `tests/test_torch_alpha.both`)
holds stacks of N unit quads, N in {4, 8, 9, 16, 17, 24}, at x = 1..N in
front of one opaque quad at x = 30; 16 rays a stack run along +X through
the quads' interiors (96 rays). The quads are alpha MASK (alpha 0.25,
cutoff 0.5: every texel rejected) for the closest-hit retries and alpha
BLEND (alpha 0.25) for alpha shadows. The JAX side runs its plain
traversal on the CPU (no Pallas call).

- The port's `trace_closest`, `rasterizer._alpha_retry_raster` (after a
  BLEND_EXCLUDE closest hit) and `trace_shadow(alpha_shadow=True)` equal
  the JAX package's on every ray: the same triangle, t within 1e-6
  relative, the same transmission bits.
- The oracle intersects every triangle in float64 and walks the hits in
  order with no bound. A retry hop moves past one rejected quad, so the
  first hit plus 8 hops reach N + 1 surfaces for N <= 8: there both
  packages hit the backstop, as the oracle does. For N > 8 the 8th hop
  lands on quad 9 (the first hit is quad 1, hop k reaches quad k + 1) and
  the loop stops there: the result is quad 9's (rejected) hit, not the
  oracle's backstop.
- An alpha shadow ray passes one surface a hop: 16 hops meet N + 1
  surfaces for N <= 15, where the transmission is the oracle's 0 behind
  the backstop. For N >= 16 the loop stops after 16 quads with
  transmission (1 - 0.25)^16 (the float32 product of 16 factors), not 0:
  the one-sided deviation JAX `trace_shadow` documents (lighter than the
  truth).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.ops import bvh as jbvh
from gltf_renderer_tpu.render import pathtracer as jpt
from gltf_renderer_tpu.render import rasterizer as jrz
from gltf_renderer_tpu.scene.gltf import load_gltf as jax_load_gltf
from gltf_renderer_tpu_torch.ops import bvh as pbvh
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.render import rasterizer as prz
from gltf_renderer_tpu_torch.scene import types as T
from gltf_renderer_tpu_torch.scene.procedural import (
    ALPHA_STACK_BACKSTOP_X,
    ALPHA_STACK_LAYERS,
    alpha_stack_rays,
    write_alpha_stack_gltf,
)
from tests.test_torch_alpha import both

torch.set_num_threads(2)
ALPHA = 0.25
T_MAX = 100.0


def _oracle_hits(world, origin, direction):
    """Per ray, the (t, triangle) of every triangle it meets, by t, in
    float64 (Moller-Trumbore, both faces)."""
    p = np.asarray(world.position, np.float64)[np.asarray(world.tri_vertex)]
    v0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    out = []
    for o, d in zip(origin.astype(np.float64), direction.astype(np.float64)):
        pv = np.cross(d, e2)
        det = (e1 * pv).sum(1)
        inv = 1.0 / np.where(np.abs(det) > 1e-12, det, np.inf)
        tv = o - v0
        u = (tv * pv).sum(1) * inv
        qv = np.cross(tv, e1)
        v = (qv * d).sum(1) * inv
        t = (e2 * qv).sum(1) * inv
        ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < T_MAX)
        ids = np.nonzero(ok)[0]
        order = np.argsort(t[ids])
        out.append([(t[i], i) for i in ids[order]])
    return out


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    d = tmp_path_factory.mktemp("stacks")
    origin, direction, stack = alpha_stack_rays()
    t_min, t_max = np.zeros(len(origin), np.float32), np.full(len(origin), T_MAX, np.float32)
    rays = (origin, direction, t_min, t_max)
    out = {"stack": stack}
    for mode in ("MASK", "BLEND"):
        s = both(jax_load_gltf(write_alpha_stack_gltf(str(d / f"{mode}.gltf"), mode, ALPHA)))
        out[mode] = dict(s, hits=_oracle_hits(s["world"], origin, direction))
    mask, blend = out["MASK"], out["BLEND"]
    assert mask["pmeta"].has_masked and blend["pmeta"].has_alpha_layer

    # JAX, once for every ray: the masked retries and the alpha shadows.
    j = [jnp.asarray(x) for x in rays]
    jm = mask["jmeta"]

    def raster_retry(sc, o, dd, tmin, tmax):
        hit = jpt.closest_hit(sc, jm, o, dd, tmin, tmax, blend_mode=jbvh.BLEND_EXCLUDE)
        return jrz._alpha_retry_raster(sc, jm, hit, o, dd, tmax)

    out["jax"] = {
        "closest": jax.jit(jpt.trace_closest, static_argnums=(1,))(mask["jscene"], jm, *j),
        "raster": jax.jit(raster_retry)(mask["jscene"], *j),
        "shadow": np.asarray(jax.jit(lambda sc, o, dd, tm: jpt.trace_shadow(
            sc, blend["jmeta"], o, dd, tm, alpha_shadow=True))(blend["jscene"], j[0], j[1], j[3])),
    }
    # The port, on the CPU (the traversal's plain version).
    p = [torch.from_numpy(x) for x in rays]
    hops = ppt.ALPHA_RETRY_HOPS, prz.RASTER_RETRY_HOPS, ppt.ALPHA_SHADOW_HOPS
    phit = ppt.closest_hit(mask["pscene"], mask["pmeta"], *p, blend_mode=pbvh.BLEND_EXCLUDE)
    out["port"] = {
        "closest": ppt.trace_closest(mask["pscene"], mask["pmeta"], *p),
        "raster": prz._alpha_retry_raster(mask["pscene"], mask["pmeta"], phit, p[0], p[1], p[3]),
        "shadow": ppt.trace_shadow(blend["pscene"], blend["pmeta"], p[0], p[1], p[3],
                                   alpha_shadow=True).numpy(),
    }
    out["hops"] = (ppt.ALPHA_RETRY_HOPS - hops[0], prz.RASTER_RETRY_HOPS - hops[1],
                   ppt.ALPHA_SHADOW_HOPS - hops[2])
    return out


def test_bounds_are_pinned(stacks):
    assert ppt.MAX_ALPHA_HOPS == jpt.MAX_ALPHA_HOPS == 8
    assert ppt.MAX_SHADOW_HOPS == jpt.MAX_SHADOW_HOPS == 16
    # The deepest stacks keep every loop running to its bound.
    assert stacks["hops"] == (8, 8, 16)


@pytest.mark.parametrize("path", ["closest", "raster"])
@pytest.mark.parametrize("n", ALPHA_STACK_LAYERS)
def test_masked_retry_bound(stacks, n, path):
    lanes = stacks["stack"] == ALPHA_STACK_LAYERS.index(n)
    got, want = stacks["port"][path], stacks["jax"][path]
    tri = got.tri.numpy()[lanes]
    np.testing.assert_array_equal(tri, np.asarray(want.tri)[lanes])
    np.testing.assert_allclose(got.t.numpy()[lanes], np.asarray(want.t)[lanes], rtol=1e-6)

    world = stacks["MASK"]["world"]
    hits = [h for h, keep in zip(stacks["MASK"]["hits"], lanes) if keep]
    alpha_mode = np.asarray(world.tri_alpha_mode)
    for (t, i), lane_hits in zip(zip(got.t.numpy()[lanes], tri), hits):
        assert len(lane_hits) == n + 1  # n quads, then the backstop
        oracle = next(h for h in lane_hits if alpha_mode[h[1]] == T.ALPHA_MODE_OPAQUE)
        assert abs(oracle[0] - ALPHA_STACK_BACKSTOP_X) < 1e-9
        reached = lane_hits[min(n, ppt.MAX_ALPHA_HOPS)]  # the first hit + 8 hops
        assert (i, t) == (reached[1], pytest.approx(reached[0], rel=1e-6))
        if n <= ppt.MAX_ALPHA_HOPS:
            assert i == oracle[1]
        else:  # quad 9, rejected, where the 8th hop stopped
            assert alpha_mode[i] == T.ALPHA_MODE_MASK and abs(t - 9.0) < 1e-5


@pytest.mark.parametrize("n", ALPHA_STACK_LAYERS)
def test_alpha_shadow_bound(stacks, n):
    lanes = stacks["stack"] == ALPHA_STACK_LAYERS.index(n)
    got = stacks["port"]["shadow"][lanes]
    np.testing.assert_array_equal(got, stacks["jax"]["shadow"][lanes])
    assert all(len(h) == n + 1 for h, keep in zip(stacks["BLEND"]["hits"], lanes) if keep)
    if n + 1 <= ppt.MAX_SHADOW_HOPS:
        np.testing.assert_array_equal(got, 0.0)  # the oracle: the backstop is opaque
    else:
        bounded = np.float32(1.0)
        for _ in range(ppt.MAX_SHADOW_HOPS):
            bounded = bounded * (np.float32(1.0) - np.float32(ALPHA))
        np.testing.assert_array_equal(got, bounded)
        assert bounded > 0.0
