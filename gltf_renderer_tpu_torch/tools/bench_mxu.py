"""Sizing of the brute-force closest-hit intersector on one CUDA card.

    python -m gltf_renderer_tpu_torch.tools.bench_mxu

Port of tools/bench_mxu.py. Moller-Trumbore's det, u*det, v*det and t*det
are bilinear in (o, d), so an (R, 16) ray-feature matrix times four
(16, T) coefficient slabs tests every (ray, triangle) pair; the question the
tool answers is what that costs against BVH traversal. Three parts, after
one warm-up launch (ops/warm.py):

1. `correctness_check`: the kernel (ops/brute.brute_closest) on 1,024 rays x
   1,024 triangles against exact numpy Moller-Trumbore; bf16 features make
   grazing edges disagree, so the bar is > 97% hit/miss agreement;
2. `k_utilization_curve`: effective TFLOP/s of one library product
   (torch.mm, bf16 inputs, f32 output) of (32768, K) x (K, 2048) against
   the contraction depth K: how much of the tensor cores a depth-16
   product can use;
3. `scale_timing`: the kernel at 262,144 rays against the helmet's
   (48,768 padded to 49,152) and the courtyard's (274,432) triangle
   counts, timed with CUDA events.

`grazing_data` makes rays that graze edges, where the kernel and its plain
version, which sum in different orders, can name different winners
(ops/brute.compare_winners).

On the CPU only the correctness check runs, on the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from gltf_renderer_tpu_torch.device import cuda_ms, resolve
from gltf_renderer_tpu_torch.ops import brute, warm
from gltf_renderer_tpu_torch.ops.brute import RB, TB

SCALE_RAYS = 262144
SCALE_WIDTHS = ((48768, "helmet"), (274432, "courtyard"))


def brute_inputs(o, d, tmin, tmax, v0, e1, e2, device):
    """The kernel's inputs on `device`: features and coefficient slabs
    rounded to bf16 once, here; tmin and tmax as (R, 1) f32."""
    def bf16(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device, torch.bfloat16)

    def col(x):
        return torch.from_numpy(np.asarray(x, np.float32)[:, None]).to(device)

    return (bf16(brute.ray_features(o, d)), col(tmin), col(tmax),
            *(bf16(c) for c in brute.mt_coefficients(v0, e1, e2)))


def correctness_data():
    """tools/bench_mxu.py's correctness data: (o, d, tmin, tmax, v0, e1,
    e2), RB rays against 2 * TB triangles, seed 0."""
    rng = np.random.default_rng(0)
    t = 2 * TB
    v0 = rng.normal(size=(t, 3)).astype(np.float32)
    e1 = rng.normal(size=(t, 3)).astype(np.float32) * 0.3
    e2 = rng.normal(size=(t, 3)).astype(np.float32) * 0.3
    o = rng.normal(size=(RB, 3)).astype(np.float32) * 2
    d = rng.normal(size=(RB, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(RB, np.float32)
    tmax = np.full(RB, 100.0, np.float32)
    return o, d, tmin, tmax, v0, e1, e2


def grazing_data(n_rays, n_tris, seed=0):
    """Rays that graze triangle edges, where sums in different orders can
    pick different winners: (o, d, tmin, tmax, v0, e1, e2) as
    `correctness_data` gives them, a soup of n_tris triangles like the
    scale timing's (v0 ~ N(0, 1), edges 0.1 N(0, 1)).

    Fifteen rays in sixteen aim at points within 1e-4 of a soup triangle's
    edge from 1 to 4 units away (t in [0, 100]). Every sixteenth ray
    crosses an edge exactly: every input is exact in bf16 and the edge
    term is 0 in exact arithmetic, while the features span 2^-36..2^24, so f32 partial sums
    round and the term's sign depends on the order of the sum. Such a ray
    comes from o = q + (2^12 a, 2^-12 b, c) (axes shuffled), heads for q
    along d = (q - o) 2^-12 and crosses, at t = 4096, the midpoint of the
    edge v0 -> v0 + e1 of its own triangle (small integer edges, put in
    the soup at a random index), t restricted to 4096 +- 2^-6."""
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.1
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.1
    tmin = np.zeros(n_rays, np.float32)
    tmax = np.full(n_rays, 100.0, np.float32)

    near = np.flatnonzero(np.arange(n_rays) % 16 != 15)
    k = near.size
    tri = rng.integers(0, n_tris, k)
    edge = rng.integers(0, 3, k)[:, None]
    s = rng.random((k, 1)).astype(np.float32)
    a, b, c = v0[tri], v0[tri] + e1[tri], v0[tri] + e2[tri]
    p = np.where(edge == 0, a + s * (b - a),
                 np.where(edge == 1, a + s * (c - a), b + s * (c - b)))
    p += rng.normal(size=(k, 3)).astype(np.float32) * 1e-4
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.zeros((n_rays, 3), np.float32)
    o[near] = p - rng.uniform(1.0, 4.0, (k, 1)).astype(np.float32) * d[near]

    exact = np.arange(15, n_rays, 16)
    own = rng.choice(n_tris, exact.size, replace=False)
    ints = np.array([1, 2, 3, 5, 6, 7], np.float32)
    for j, t in zip(exact, own):
        big, tiny, mid = rng.permutation(3)
        a, b, c = rng.choice(ints, 3) * rng.choice([-1.0, 1.0], 3)
        q = np.zeros(3, np.float32)
        q[mid] = rng.integers(-2, 3)
        off = np.zeros(3, np.float32)
        off[big], off[tiny], off[mid] = a * 2.0 ** 12, b * 2.0 ** -12, c
        while True:
            f1, f2 = rng.integers(-2, 3, (2, 3)).astype(np.float32)
            n = np.cross(f1, f2)
            if n[big] != 0:
                break
        if np.dot(off, n) < 0:  # det = 2^-12 (o - q).n > 0
            f2 = -f2
        o[j] = q + off
        d[j] = -off * np.float32(2.0 ** -12)
        v0[t], e1[t], e2[t] = q - f1 / 2, f1, f2
        tmin[j], tmax[j] = 4096.0 - 2.0 ** -6, 4096.0 + 2.0 ** -6
    return o, d, tmin, tmax, v0, e1, e2


def correctness_check(device="cuda") -> float:
    """The kernel against exact numpy Moller-Trumbore on the correctness
    data; raises below 97% hit/miss agreement. Returns the agreement."""
    data = correctness_data()
    key, blk = brute.brute_closest(*brute_inputs(*data, resolve(device)))
    t_k, tri_k = brute.decode_winner(key.cpu().numpy(), blk.cpu().numpy())
    t_r, tri_r = brute.brute_reference(*data)

    both_hit = (tri_k >= 0) & (tri_r >= 0)
    agree = tri_k == tri_r
    miss_agree = float(((tri_k < 0) == (tri_r < 0)).mean())
    same = both_hit & agree
    rel = np.abs(t_k[same] - t_r[same]) / np.maximum(t_r[same], 1e-6)
    print(f"correctness: {miss_agree * 100:.2f}% hit/miss agreement, "
          f"{agree[both_hit].mean() * 100:.2f}% same winner, "
          f"max rel t err {rel.max() if rel.size else 0:.2e} "
          f"(bf16 features: small disagreement at grazing edges expected)", flush=True)
    if miss_agree <= 0.97:
        raise AssertionError(f"hit/miss agreement {miss_agree:.4f} is not above 0.97")
    return miss_agree


def k_utilization_curve(device="cuda"):
    """Effective TFLOP/s of a bf16 (R, K) x (K, N) product with an f32
    output (`torch.mm(..., out_dtype=torch.float32)`, as the JAX tool's
    preferred_element_type=float32) against K. Returns [(K, ms, TFLOP/s)]."""
    dev = resolve(device)
    r, n = 32768, 2048
    print(f"--- bf16 x bf16 -> f32 torch.mm, R={r} N={n}: effective TFLOP/s against "
          f"depth K ---")
    rows = []
    for k in (16, 32, 64, 128, 256, 512):
        a = torch.ones((r, k), dtype=torch.bfloat16, device=dev)
        b = torch.ones((k, n), dtype=torch.bfloat16, device=dev)
        ms = cuda_ms(lambda: torch.mm(a, b, out_dtype=torch.float32), 16, warmup=2)
        tf = 2 * r * k * n / (ms * 1e-3) / 1e12
        print(f"  K={k:4d}: {ms:7.3f} ms -> {tf:6.1f} TFLOP/s effective", flush=True)
        rows.append((k, ms, tf))
    return rows


def scale_inputs(device="cuda"):
    """The scale timing's inputs, one width at a time: yields (name, ins)
    with ins as `brute_inputs` gives them, SCALE_RAYS rays from seed 1
    against each of SCALE_WIDTHS padded to a multiple of TB."""
    dev = resolve(device)
    rng = np.random.default_rng(1)
    r = SCALE_RAYS
    o = rng.normal(size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(r, np.float32)
    tmax = np.full(r, 100.0, np.float32)
    for t_real, name in SCALE_WIDTHS:
        t_pad = -(-t_real // TB) * TB
        v0 = rng.normal(size=(t_pad, 3)).astype(np.float32)
        e1 = rng.normal(size=(t_pad, 3)).astype(np.float32) * 0.1
        e2 = rng.normal(size=(t_pad, 3)).astype(np.float32) * 0.1
        yield name, brute_inputs(o, d, tmin, tmax, v0, e1, e2, dev)


def scale_timing(device="cuda", reps: int = 4):
    """The kernel on each of `scale_inputs`, by CUDA events. Returns one
    dict per width: name, rays, tris (padded), ms, bytes (inputs once +
    outputs) and product_tflops, the four depth-16 products' rate
    (4 * 2 * 16 * R * T operations over ms), comparable with
    `k_utilization_curve`'s depth-16 row."""
    rows = []
    for name, ins in scale_inputs(device):
        r, t_pad = ins[0].shape[0], ins[3].shape[1]
        ms = cuda_ms(lambda: brute.brute_closest(*ins), reps)
        slab_mb = sum(c.numel() * c.element_size() for c in ins[3:]) / 1e6
        n_bytes = sum(x.numel() * x.element_size() for x in ins) + 2 * 4 * r
        tflops = 4 * 2 * 16 * r * t_pad / (ms * 1e-3) / 1e12
        print(f"{name} (T={t_pad}, coefficient slabs {slab_mb:.1f} MB): {ms:8.2f} ms per "
              f"{r}-ray batch = {ms / r * 1e6:.0f} ns/ray "
              f"({r * t_pad / (ms * 1e-3) / 1e12:.3f} Tpairs/s, products at {tflops:.1f} "
              f"TFLOP/s)", flush=True)
        rows.append({"name": name, "rays": r, "tris": t_pad, "ms": ms, "bytes": n_bytes,
                     "product_tflops": tflops})
    return rows


def main(device="cuda"):
    """Warm-up, correctness, then (on a card) the K curve and the scale
    timings. Returns (k_utilization_curve's rows, scale_timing's rows), or
    None on the CPU."""
    dev = resolve(device)
    warm.warm(dev)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)
    correctness_check(dev)
    if dev.type == "cpu":
        print("(CPU: correctness only, on the plain version; run on the card for timings)")
        return None
    return k_utilization_curve(dev), scale_timing(dev)


if __name__ == "__main__":
    main()
