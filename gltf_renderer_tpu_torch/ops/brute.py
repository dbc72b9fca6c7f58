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
  (csrc/brute.cu), its slabs repacked by `pack_slabs`, or the call raises.
- `brute_closest_ref`, the plain PyTorch version: the sums in order
  k = 0..15, every multiply and add rounded on its own, and the TPU
  kernel's epilogue, in ray chunks so no R x T matrix larger than
  CHUNK_ELEMS is ever made. It equals the TPU kernel bit for bit on the CPU.
- `pack_slabs`: the kernel's tile layout of the four slabs.
- `brute_sums`: the four sums of every pair as the kernel (on a card) or
  the plain version (on the CPU) computes them.
- `compare_winners`: the contract between the kernel and the plain
  version, which sum in different orders (see its docstring).
- numpy copies of `mt_coefficients`, `ray_features`, `decode_winner` and
  `brute_reference` (exact numpy Moller-Trumbore, small sizes only).
- `KERNEL_LAUNCHES`, `SUMS_LAUNCHES` and `REFERENCE_CALLS`, plain counters.

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
TN = 32  # triangles per kernel tile: its columns are [det | ud | vd | td], 4 x TN
RAYS_PER_CTA = 256  # rays per CUDA block of the kernel
# compare_winners' bound on a sum's error, relative to sum_k |f_k c_k|. The
# plain version's ordered 16-term f32 sum errs by at most 15 * 2^-24 of it;
# 2^-16 is 17x that and leaves room for the tensor cores' accumulator.
DELTA = 2.0 ** -16

KERNEL_LAUNCHES = 0
SUMS_LAUNCHES = 0
REFERENCE_CALLS = 0

_SOURCE = "brute.cu"
_ARGTYPES = [_build.VP] * 4 + [_build.CI] * 2 + [_build.VP] * 3
_SUMS_ARGTYPES = [_build.VP] * 2 + [_build.CI] * 2 + [_build.VP] * 2


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


def pack_slabs(cdet, cud, cvd, ctd):
    """The four (16, T) slabs as the kernel's tiles: (T / TN, 16, 2, 8, 8),
    contiguous. Tile i is the (16 x 4TN) B operand of one wgmma, columns
    n = q * TN + j for quantity q (det, ud, vd, td) of triangle i * TN + j,
    stored K-major in wgmma's no-swizzle layout: element [i, g, c, r, e] is
    column 8g + r at depth 8c + e, so every 8 columns x 8 depths is one
    128-byte core matrix, the two depth halves 128 bytes apart and column
    groups 256 bytes apart."""
    t = cdet.shape[1]
    s = torch.stack((cdet, cud, cvd, ctd)).view(4, 2, 8, t // TN, 4, 8)  # q, c, e, i, m, r
    return s.permute(3, 0, 4, 1, 5, 2).contiguous().view(t // TN, 4 * TN // 8, 2, 8, 8)


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
    ins = [x.contiguous() for x in (feats, tmin, tmax)] + [pack_slabs(cdet, cud, cvd, ctd)]
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


def brute_sums(feats, cdet, cud, cvd, ctd):
    """(4, R, T) f32: det, ud, vd and td of every (ray, triangle) pair as
    the kernel's tensor cores sum them (a CUDA tensor; R a multiple of
    RAYS_PER_CTA, T of TB) or as the plain version sums them (a CPU tensor:
    k = 0..15 in order). For compare_winners' sum deviation, on a sample
    of rays."""
    global SUMS_LAUNCHES
    r, t = feats.shape[0], cdet.shape[1]
    dev = feats.device
    if dev.type == "cpu":
        f = feats.float()
        return torch.stack([_dot16(f, c.float()) for c in (cdet, cud, cvd, ctd)])
    if dev.type != "cuda":
        raise ValueError(f"brute_sums runs on cpu or cuda tensors, got {dev}")
    if r % RAYS_PER_CTA or t % TB:
        raise ValueError(f"brute_sums takes rays in multiples of {RAYS_PER_CTA} and triangles "
                         f"in multiples of {TB}, got {r} x {t}")
    tiles = pack_slabs(cdet, cud, cvd, ctd)
    feats = feats.contiguous()
    out = torch.empty((4, r, t), dtype=torch.float32, device=dev)
    _build.launch(_build.entry(_SOURCE, "brute_sums_launch", _SUMS_ARGTYPES), "brute_sums",
                  dev.index, feats.data_ptr(), tiles.data_ptr(), r, t, out.data_ptr())
    SUMS_LAUNCHES += 1
    return out


def _exact_terms(feats, tmin, tmax, slabs, rows, tris):
    """Exact f64 sums of the (ray, triangle) pairs (rows[i], tris[i]) from
    the same bf16 inputs: (det, td, det's scale, td's scale, [(term, scale)]
    for det, ud, vd, m3, m4, m5), each scale the sum of the absolute products
    the term is made of."""
    f = feats[rows].double()
    sums, scales = [], []
    for c in slabs:
        p = f * c[:, tris].double().T
        sums.append(p.sum(1))
        scales.append(p.abs().sum(1))
    det, ud, vd, td = sums
    s_det, s_ud, s_vd, s_td = scales
    lo, hi = tmin[rows, 0].double(), tmax[rows, 0].double()
    terms = [(det, s_det), (ud, s_ud), (vd, s_vd), (det - ud - vd, s_det + s_ud + s_vd),
             (td - lo * det, s_td + lo.abs() * s_det), (hi * det - td, hi.abs() * s_det + s_td)]
    return det, td, s_det, s_td, terms


def _winner_check(feats, tmin, tmax, slabs, rows, key, blk):
    """For each ray rows[i] and the winner (key[i], blk[i]) one side reports
    for it: (present, borderline, robust, key_lo, key_hi). borderline: a
    predicate term lies within DELTA * its scale of 0. robust: an exact hit,
    not borderline, whose reported t lies where sums within DELTA put it;
    key_lo..key_hi is the range its key can take then."""
    present = blk >= 0
    lane = key & LANE_BITS
    tris = torch.where(present, blk * TB + lane, torch.zeros_like(blk)).long()
    det, td, s_det, s_td, terms = _exact_terms(feats, tmin, tmax, slabs, rows, tris)
    border = torch.zeros_like(present)
    nonneg = torch.ones_like(present)
    nonpos = torch.ones_like(present)
    for v, s in terms:
        border |= v.abs() <= DELTA * s
        nonneg &= v >= 0
        nonpos &= v <= 0
    hit = ((det > 0) & nonneg) | ((det < 0) & nonpos)
    # t = td / det with each sum off by at most DELTA * its scale, then
    # rounded to f32 (2^-23 either side covers the division and the cast).
    a = DELTA * s_td / td.abs().clamp_min(1e-300)
    b = (DELTA * s_det / det.abs().clamp_min(1e-300)).clamp_max(0.999)  # >= 1: borderline
    t = td / torch.where(det == 0, torch.ones_like(det), det)
    t_lo = (t * (1 - a) / (1 + b) * (1 - 2.0 ** -23)).clamp_min(0.0)
    t_hi = t * (1 + a) / (1 - b) * (1 + 2.0 ** -23)

    def tbits(x):
        return x.float().view(torch.int32) & ~LANE_BITS

    key_lo, key_hi = tbits(t_lo) | lane, tbits(t_hi) | lane
    robust = present & hit & ~border & (key >= key_lo) & (key <= key_hi)
    return present, present & border, robust, key_lo, key_hi


def compare_winners(ins, got, want, sums=None):
    """Hold a closest-hit answer `got` (key, blk) to `want` on the inputs
    `ins` (brute_closest's seven arguments), when the two sum the 16
    products in different orders.

    A ray agrees when both name the same block and lane and their keys' t
    bits are at most one unit (0x200) apart. Any other ray is explained
    when the sums' rounding can account for it: for the winners the two
    sides name, the exact sums (f64 from the same bf16 inputs) show either
    - a winner's predicate term (det, ud, vd, m3, m4 or m5) within
      DELTA * sum_k |f_k c_k| of 0, so one side could see it hit and the
      other miss; or
    - both winners exact hits, each side's t where sums within DELTA put
      it, and the ranges their keys can take overlapping, so their order
      can go either way (two t within DELTA of each other, or one near a
      boundary of the key's 14-bit truncation).
    Everything else is unexplained.

    `sums`, optionally (rows, s): `got`'s side's sums s (4, len(rows), T),
    as brute_sums gives them, of the rays rows; the largest
    |s - exact| / sum_k |f_k c_k| over them is returned as max_sum_dev.

    Returns {rays, agree, explained, unexplained, both_hit, max_sum_dev,
    unexplained_rays (the first 16)}."""
    feats, tmin, tmax, *slabs = ins
    kg, bg = (x.reshape(-1) for x in got)
    kw, bw = (x.reshape(-1) for x in want)
    kg, bg, kw, bw = (x.to(feats.device) for x in (kg, bg, kw, bw))
    step = ((kg & ~LANE_BITS).long() - (kw & ~LANE_BITS).long()).abs()
    differ = (bg != bw) | ((kg & LANE_BITS) != (kw & LANE_BITS)) | (step > 0x200)
    rows = differ.nonzero().reshape(-1)
    out = {"rays": int(kg.numel()), "agree": int(kg.numel() - rows.numel()),
           "both_hit": int(((bg >= 0) & (bw >= 0)).sum()), "max_sum_dev": None}
    g = _winner_check(feats, tmin, tmax, slabs, rows, kg[rows], bg[rows])
    w = _winner_check(feats, tmin, tmax, slabs, rows, kw[rows], bw[rows])
    overlap = (g[3] <= w[4]) & (w[3] <= g[4])
    explained = g[1] | w[1] | (g[2] & w[2] & overlap)
    out["explained"] = int(explained.sum())
    out["unexplained"] = int((~explained).sum())
    out["unexplained_rays"] = rows[~explained][:16].tolist()
    if sums is not None:
        s_rows, s = sums
        f = feats[s_rows].double()
        worst = 0.0
        for q, c in enumerate(slabs):
            c = c.double()
            scale = f.abs() @ c.abs()
            dev = (s[q].double() - f @ c).abs() / torch.where(scale > 0, scale,
                                                                torch.ones_like(scale))
            worst = max(worst, float(dev.max()))
        out["max_sum_dev"] = worst
    return out
