"""Brute-force closest hit over a ray-feature x coefficient product.

Port of tools/bench_mxu.py's study kernel (`make_brute_kernel`) and the
numpy helpers around it. Moller-Trumbore's det, u*det, v*det and t*det are
bilinear in (o, d): with a ray's 16 features (o, d, d_i*o_k, 1) and a
triangle's four (16,) coefficient columns, each is one dot product, so a
ray batch against a triangle set is four (R, 16) x (16, T) products plus a
per-pair epilogue and a running minimum.

- `brute_closest`, the wrapper, with the JAX layout: feats (R, 16) bf16,
  tmin and tmax (R, 1) f32, four (16, T) bf16 slabs; returns key and blk,
  each (R, 1) int32. A CPU tensor goes to the plain version
  `brute_closest_ref`; a CUDA tensor goes to the CUDA kernel
  (csrc/brute.cu), or the call raises.
- `brute_closest_ref`, the plain PyTorch version: the same sums in the same
  order (k = 0..15, every multiply and add rounded on its own) and the same
  epilogue, in ray chunks so no R x T matrix larger than CHUNK_ELEMS is
  ever made. It equals the kernel bit for bit.
- numpy copies of `mt_coefficients`, `ray_features`, `decode_winner` and
  `brute_reference` (exact numpy Moller-Trumbore, small sizes only).
- `KERNEL_LAUNCHES` and `REFERENCE_CALLS`, plain counters.

Output contract (as the TPU kernel): the key is
(bits(t) & ~0x1FF) | lane, lane the triangle's index in its TB-triangle
block, blk the block's index; key starts at 0x7F7FFFFF and blk at -1, a ray
that hits nothing keeps both, and a later block replaces the winner only
with a strictly smaller key. Only 14 bits of t's mantissa survive in the
key, so near-equal hits tie on the lane.
"""

from __future__ import annotations

import numpy as np
import torch

from gltf_renderer_tpu_torch.ops import _build

RB = 1024  # rays per block of the TPU kernel's grid: R must be a multiple
TB = 512   # triangles per key block
KEY_INIT = 0x7F7FFFFF
LANE_BITS = 0x1FF
CHUNK_ELEMS = 1 << 24  # largest (rays x triangles) matrix the plain version makes

KERNEL_LAUNCHES = 0
REFERENCE_CALLS = 0

_SOURCE = "brute.cu"
_ARGTYPES = [_build.VP] * 7 + [_build.CI] * 2 + [_build.VP] * 3


def mt_coefficients(v0, e1, e2):
    """(16, T) f32 coefficient slabs for det, u*det, v*det, t*det of
    triangles (v0, v0 + e1, v0 + e2); feature order o(3), d(3), d_i*o_k(9),
    1."""
    t = v0.shape[0]
    n = np.cross(e1, e2)

    def skew_flat(a):  # rows 6:15: d.(a x o) as sum_ik d_i o_k skew(a)_ik
        z = np.zeros(t)
        s = np.stack([
            np.stack([z, -a[:, 2], a[:, 1]], 1),
            np.stack([a[:, 2], z, -a[:, 0]], 1),
            np.stack([-a[:, 1], a[:, 0], z], 1),
        ], 1)  # (T, 3, 3): i index, then k
        return s.reshape(t, 9).T

    c_det = np.zeros((16, t), np.float32)
    c_det[3:6] = -n.T
    c_ud = np.zeros((16, t), np.float32)
    c_ud[3:6] = -np.cross(e2, v0).T
    c_ud[6:15] = skew_flat(e2)
    c_vd = np.zeros((16, t), np.float32)
    c_vd[3:6] = -np.cross(v0, e1).T
    c_vd[6:15] = -skew_flat(e1)
    c_td = np.zeros((16, t), np.float32)
    c_td[0:3] = n.T
    c_td[15] = -np.sum(v0 * n, -1)
    return c_det, c_ud, c_vd, c_td


def ray_features(o, d):
    """(R, 16) f32 features: o, d, d_i*o_k (i-major), 1."""
    return np.concatenate(
        [o, d, (d[:, :, None] * o[:, None, :]).reshape(-1, 9),
         np.ones((o.shape[0], 1), np.float32)], -1)


def decode_winner(key, blk):
    """(t with its low mantissa bits cleared, global triangle id or -1)
    from the packed (R, 1) outputs."""
    key = np.asarray(key)[:, 0]
    blk = np.asarray(blk)[:, 0]
    lane = key & LANE_BITS
    tbits = key & ~LANE_BITS
    t = np.frombuffer(tbits.astype(np.int32).tobytes(), np.float32)
    miss = ~np.isfinite(t)
    tri = np.where(miss, -1, blk * TB + lane)
    return t, tri


def brute_reference(o, d, tmin, tmax, v0, e1, e2):
    """Exact numpy Moller-Trumbore closest hit, (t or inf, triangle or -1)
    per ray (small sizes only: it makes R x T matrices). The d.(a x o)
    terms use d.(a x o) = a.(o x d)."""
    n = np.cross(e1, e2)
    oxd = np.cross(o[:, None, :], d[:, None, :])[:, 0, :]
    det = -np.einsum("rk,tk->rt", d, n)
    ud = (np.einsum("rk,tk->rt", oxd, e2)
          - np.einsum("rk,tk->rt", d, np.cross(e2, v0)))
    vd = (-np.einsum("rk,tk->rt", oxd, e1)
          - np.einsum("rk,tk->rt", d, np.cross(v0, e1)))
    td = np.einsum("rk,tk->rt", o, n) - (v0 * n).sum(-1)[None, :]
    s = np.sign(det)
    us, vs, ts, ad = ud * s, vd * s, td * s, np.abs(det)
    hit = ((ad > 0) & (us >= 0) & (vs >= 0) & (us + vs <= ad)
           & (ts >= tmin[:, None] * ad) & (ts <= tmax[:, None] * ad))
    t = np.where(hit, td / np.where(det == 0, 1, det), np.inf)
    best = t.argmin(1)
    tbest = t[np.arange(len(o)), best]
    return np.where(np.isfinite(tbest), tbest, np.inf), np.where(
        np.isfinite(tbest), best, -1)


def _check_inputs(feats, tmin, tmax, slabs):
    """Validate types and shapes; returns (R, T)."""
    r = feats.shape[0]
    t = slabs[0].shape[1] if slabs[0].dim() == 2 else -1
    want = [("feats", feats, torch.bfloat16, (r, 16)),
            ("tmin", tmin, torch.float32, (r, 1)),
            ("tmax", tmax, torch.float32, (r, 1))]
    want += [(name, c, torch.bfloat16, (16, t))
             for name, c in zip(("cdet", "cud", "cvd", "ctd"), slabs)]
    for name, x, dtype, shape in want:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != feats.device:
            raise ValueError(f"{name} is on {x.device}, feats on {feats.device}")
    if r % RB:
        raise ValueError(f"ray count {r} is not a multiple of {RB}")
    if t % TB:
        raise ValueError(f"triangle count {t} is not a multiple of {TB}")
    return r, t


def brute_closest(feats, tmin, tmax, cdet, cud, cvd, ctd):
    """Closest hit of every ray over every triangle. Returns (key, blk),
    each (R, 1) int32. R must be a multiple of RB and T of TB."""
    global KERNEL_LAUNCHES
    r, _ = _check_inputs(feats, tmin, tmax, (cdet, cud, cvd, ctd))
    dev = feats.device
    if dev.type == "cpu":
        return brute_closest_ref(feats, tmin, tmax, cdet, cud, cvd, ctd)
    if dev.type != "cuda":
        raise ValueError(f"brute_closest runs on cpu or cuda tensors, got {dev}")
    ins = [x.contiguous() for x in (feats, tmin, tmax, cdet, cud, cvd, ctd)]
    key = torch.empty((r, 1), dtype=torch.int32, device=dev)
    blk = torch.empty_like(key)
    _build.launch(_build.entry(_SOURCE, "brute_closest_launch", _ARGTYPES), "brute_closest",
                  dev.index, *[x.data_ptr() for x in ins], r, cdet.shape[1], key.data_ptr(),
                  blk.data_ptr())
    KERNEL_LAUNCHES += 1
    return key, blk


def _dot16(f, c):
    """(n, 16) x (16, T) -> (n, T), summed k = 0..15 in order."""
    acc = f[:, 0:1] * c[0]
    for k in range(1, 16):
        acc = acc + f[:, k:k + 1] * c[k]
    return acc


def brute_closest_ref(feats, tmin, tmax, cdet, cud, cvd, ctd):
    """Plain PyTorch version of the kernel (same sums, same epilogue)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    r, t = _check_inputs(feats, tmin, tmax, (cdet, cud, cvd, ctd))
    dev = feats.device
    f = feats.float()
    slabs = [c.float() for c in (cdet, cud, cvd, ctd)]
    lane = torch.arange(TB, dtype=torch.int32, device=dev).repeat(t // TB)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    step = max(1, CHUNK_ELEMS // t)
    keys, blks = [], []
    for s in range(0, r, step):
        fc = f[s:s + step]
        lo, hi = tmin[s:s + step], tmax[s:s + step]
        det, ud, vd, td = (_dot16(fc, c) for c in slabs)
        m3 = det - ud - vd
        m4 = td - lo * det
        m5 = hi * det - td
        a = torch.minimum(torch.minimum(ud, vd), torch.minimum(m3, torch.minimum(m4, m5)))
        b = torch.maximum(torch.maximum(ud, vd), torch.maximum(m3, torch.maximum(m4, m5)))
        hit = ((det > 0) & (a >= 0)) | ((det < 0) & (b <= 0))
        tb = torch.where(hit, td / det, inf)
        key = (tb.view(torch.int32) & ~LANE_BITS) | lane
        kmin = key.view(fc.shape[0], t // TB, TB).amin(-1)  # (n, blocks)
        best = kmin.amin(-1, keepdim=True)
        first = (kmin == best).to(torch.int32).argmax(-1, keepdim=True)
        better = best < KEY_INIT  # the running minimum's strict < from KEY_INIT
        keys.append(torch.where(better, best, torch.full_like(best, KEY_INIT)))
        blks.append(torch.where(better, first.to(torch.int32), torch.full_like(best, -1)))
    return torch.cat(keys), torch.cat(blks)
