"""Closest-hit / any-hit traversal of the 4-wide BVH.

Port of gltf_renderer_tpu/ops/pallas_trace.py::traverse_packets_wide. Three
things live here:

- `traverse_wide`, the wrapper the path tracer calls. A CPU tensor goes to
  the plain version; a CUDA tensor goes to the CUDA kernel
  (csrc/traverse.cu), or the call raises. There is no fallback between them.
- `traverse_wide_ref`, the plain PyTorch version: the same tables, the same
  depth-first order (the children whose box a ray enters visited nearest
  first, by entry distance and then child index; a leaf tested when popped)
  and the same arithmetic as the kernel, vectorised over rays with an
  (R, S) stack tensor. It runs on either device.
- `KERNEL_LAUNCHES` and `REFERENCE_CALLS`, plain counters of kernel
  launches and plain-version calls, so a run can show which one it used.

Semantics (as the TPU kernel): for each ray, the closest triangle with
t_min < t < t_best over the tables, or for any-hit rays the first accepted
triangle in traversal order, which retires the ray (its t is then NEG_BIG
and carries no meaning). A miss returns t = t_max, u = v = 0, word = -1.
"""

from __future__ import annotations

import functools

import torch

from gltf_renderer_tpu_torch.ops import _build
from gltf_renderer_tpu_torch.ops.bvh import (
    BLEND_EXCLUDE,
    BLEND_ONLY,
    FLAG_BLEND,
    FLAG_DOUBLE_SIDED,
    LEAF_SIZE,
    REC_GEO,
    WIDE_ID_MASK,
    WIDE_LEAF_BIT,
)

NEG_BIG = -3.0e38

KERNEL_LAUNCHES = 0
REFERENCE_CALLS = 0

_SOURCE = "traverse.cu"
_ARGTYPES = [_build.VP] * 9 + [_build.CI] * 6 + [_build.VP] * 5


def _any_mode(any_hit) -> int:
    if any_hit == "lane":
        return 2
    if any_hit is True:
        return 1
    if any_hit is False:
        return 0
    raise ValueError(f"any_hit must be False, True or 'lane', got {any_hit!r}")


def _check_inputs(nodes, meta, records, words, origin, direction, t_min, t_max, any_hit, mode):
    """Validate types and shapes; returns (t_max as (R,), mode or None)."""
    r = origin.shape[0]
    want = [
        ("nodes", nodes, torch.float32, (None, 24)),
        ("meta", meta, torch.int32, (nodes.shape[0], 4)),
        ("records", records, torch.float32, (None, REC_GEO)),
        ("words", words, torch.int32, (records.shape[0], LEAF_SIZE)),
        ("origin", origin, torch.float32, (r, 3)),
        ("direction", direction, torch.float32, (r, 3)),
        ("t_min", t_min, torch.float32, (r,)),
    ]
    for name, x, dtype, shape in want:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, x.shape)):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != origin.device:
            raise ValueError(f"{name} is on {x.device}, origin on {origin.device}")
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=origin.device),
                               (r,))
    if (any_hit == "lane") != (mode is not None):
        raise ValueError("mode is required with any_hit='lane' and only then")
    if mode is not None:
        if mode.dtype != torch.int32 or tuple(mode.shape) != (r,) or mode.device != origin.device:
            raise ValueError("mode must be an (R,) int32 tensor on the rays' device")
    return t_max, mode


@functools.cache
def max_stack_bound() -> int:
    """Largest tree stack bound the kernel takes: its stack, one entry per
    thread and level, must fit the shared memory one block may use."""
    return _build.entry(_SOURCE, "traverse_wide_max_stack", [])()


def traverse_wide(nodes, meta, records, words, origin, direction, t_min, t_max,
                  root_meta: int, any_hit=False, cull_sign: int = 0, blend_mode: int = 0,
                  mode=None, *, stack_bound: int):
    """Traverse every ray. Returns (t, word, u, v), each (R,).

    nodes (N4, 24) f32 wide boxes; meta (N4, 4) i32 child meta words;
    records (L, REC_GEO) f32 and words (L, LEAF_SIZE) i32 compact leaf
    tables; origin/direction (R, 3) f32; t_min (R,) f32; t_max (R,) or
    scalar. any_hit: False, True or "lane" (then mode (R,) i32, > 0 marks an
    any-hit ray). stack_bound: ops.bvh.wide_stack_bound of the tree.
    """
    global KERNEL_LAUNCHES
    _any_mode(any_hit)
    t_max, mode = _check_inputs(nodes, meta, records, words, origin, direction,
                                t_min, t_max, any_hit, mode)
    dev = origin.device
    if dev.type == "cpu":
        return traverse_wide_ref(nodes, meta, records, words, origin, direction, t_min,
                                 t_max, root_meta, any_hit, cull_sign, blend_mode, mode,
                                 stack_bound=stack_bound)
    if dev.type != "cuda":
        raise ValueError(f"traverse_wide runs on cpu or cuda tensors, got {dev}")

    if stack_bound > max_stack_bound():
        raise ValueError(
            f"tree needs a traversal stack of {stack_bound} entries; the kernel takes "
            f"at most {max_stack_bound()}, as its stack must fit a block's shared memory")
    r = origin.shape[0]
    out_t = torch.empty(r, dtype=torch.float32, device=dev)
    out_u = torch.empty_like(out_t)
    out_v = torch.empty_like(out_t)
    out_w = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return out_t, out_w, out_u, out_v
    ins = [x.contiguous() for x in (nodes, meta, records, words, origin, direction,
                                    t_min, t_max)]
    if any(x.data_ptr() % 16 for x in ins[:4]):
        raise ValueError("nodes, meta, records and words must start 16-byte aligned "
                         "(read as float4/int4 rows)")
    mode_ptr = mode.contiguous().data_ptr() if mode is not None else None
    _build.launch(_build.entry(_SOURCE, "traverse_wide_launch", _ARGTYPES), "traverse_wide",
                  dev.index, *[x.data_ptr() for x in ins], mode_ptr, r, int(root_meta),
                  _any_mode(any_hit), int(cull_sign), int(blend_mode), int(stack_bound),
                  out_t.data_ptr(), out_u.data_ptr(), out_v.data_ptr(), out_w.data_ptr())
    KERNEL_LAUNCHES += 1
    return out_t, out_w, out_u, out_v


def _order2(key, idx, ent, a, b):
    """One compare-exchange of the kernel's 4-input sorting network: columns
    a and b ordered by (key, child index), each child's entry carried."""
    swap = (key[b] < key[a]) | ((key[b] == key[a]) & (idx[b] < idx[a]))
    for col in (key, idx, ent):
        col[a], col[b] = torch.where(swap, col[b], col[a]), torch.where(swap, col[a], col[b])


def _inv_dir(d):
    big = 1e30
    return torch.where(torch.abs(d) > 1e-20, torch.reciprocal(d), torch.sign(d) * big + big)


def traverse_wide_ref(nodes, meta, records, words, origin, direction, t_min, t_max,
                      root_meta: int, any_hit=False, cull_sign: int = 0, blend_mode: int = 0,
                      mode=None, *, stack_bound: int, visits=None):
    """Plain PyTorch version of the kernel (same order, same arithmetic).
    visits: an optional dict whose "node" and "leaf" entries are increased
    by the number of (ray, node) and (ray, leaf) visits, the work the kernel
    does on these rays."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    any_mode = _any_mode(any_hit)
    dev = origin.device
    r = origin.shape[0]
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (r,))
    if any_mode == 2:
        lane_any = mode > 0
    else:
        lane_any = torch.full((r,), any_mode == 1, dtype=torch.bool, device=dev)
    cull_lane = torch.full((r,), cull_sign != 0, dtype=torch.bool, device=dev)
    if any_mode == 2:
        cull_lane = cull_lane & ~lane_any

    o = origin
    d = direction
    inv = _inv_dir(d)
    t_best = t_max.clone()
    u_best = torch.zeros(r, dtype=torch.float32, device=dev)
    v_best = torch.zeros(r, dtype=torch.float32, device=dev)
    w_best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((r, max(int(stack_bound), 1)), dtype=torch.int32, device=dev)
    stack[:, 0] = int(root_meta)
    sp = (t_min <= t_max).to(torch.int64)

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        entry = stack[act, sp[act]]
        is_leaf = (entry & WIDE_LEAF_BIT) != 0
        ids = entry & WIDE_ID_MASK

        ia = act[~is_leaf]
        la = act[is_leaf]
        if visits is not None:
            visits["node"] = visits.get("node", 0) + int(ia.numel())
            visits["leaf"] = visits.get("leaf", 0) + int(la.numel())
        if ia.numel():
            node = ids[~is_leaf].long()
            box = nodes[node]
            mrow = meta[node]
            ox, oy, oz = o[ia, 0], o[ia, 1], o[ia, 2]
            ix, iy, iz = inv[ia, 0], inv[ia, 1], inv[ia, 2]
            tmn = t_min[ia]
            tb = t_best[ia]
            key, idx, ent = [], [], []
            for c in range(4):
                tx0 = (box[:, 6 * c] - ox) * ix
                tx1 = (box[:, 6 * c + 3] - ox) * ix
                ty0 = (box[:, 6 * c + 1] - oy) * iy
                ty1 = (box[:, 6 * c + 4] - oy) * iy
                tz0 = (box[:, 6 * c + 2] - oz) * iz
                tz1 = (box[:, 6 * c + 5] - oz) * iz
                tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                                   torch.minimum(tz0, tz1))
                tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                                   torch.maximum(tz0, tz1))
                hit = (tf >= torch.maximum(tn, tmn)) & (tn <= tb)
                key.append(torch.where(hit, tn, torch.full_like(tn, float("inf"))))
                idx.append(torch.full_like(node, c))
                ent.append(torch.where(hit, mrow[:, c], torch.full_like(mrow[:, c], -1)))
            # Nearest child first: sort by (entry distance, child index) and
            # push in reverse, so the nearest is popped next.
            for a, b in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
                _order2(key, idx, ent, a, b)
            sp_i = sp[ia]
            for c in range(3, -1, -1):
                h = ent[c] >= 0
                stack[ia[h], sp_i[h]] = ent[c][h]
                sp_i = sp_i + h.to(torch.int64)
            sp[ia] = sp_i

        if la.numel():
            leaf = ids[is_leaf].long()
            rec = records[leaf]
            wrd = words[leaf]
            ox, oy, oz = o[la, 0], o[la, 1], o[la, 2]
            dx, dy, dz = d[la, 0], d[la, 1], d[la, 2]
            tmn = t_min[la]
            l_any = lane_any[la]
            l_cull = cull_lane[la]
            t_b, u_b, v_b, w_b = t_best[la], u_best[la], v_best[la], w_best[la]
            retired = torch.zeros_like(l_any)
            for k in range(LEAF_SIZE):
                p0x, p0y, p0z = rec[:, 9 * k], rec[:, 9 * k + 1], rec[:, 9 * k + 2]
                e1x, e1y, e1z = rec[:, 9 * k + 3], rec[:, 9 * k + 4], rec[:, 9 * k + 5]
                e2x, e2y, e2z = rec[:, 9 * k + 6], rec[:, 9 * k + 7], rec[:, 9 * k + 8]
                word = wrd[:, k]
                pvx = dy * e2z - dz * e2y
                pvy = dz * e2x - dx * e2z
                pvz = dx * e2y - dy * e2x
                det = e1x * pvx + e1y * pvy + e1z * pvz
                det_ok = torch.abs(det) > 1e-12
                inv_det = torch.where(det_ok, torch.reciprocal(det), torch.zeros_like(det))
                tvx = ox - p0x
                tvy = oy - p0y
                tvz = oz - p0z
                uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
                qvx = tvy * e1z - tvz * e1y
                qvy = tvz * e1x - tvx * e1z
                qvz = tvx * e1y - tvy * e1x
                vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
                tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
                h = (det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                     & (tt > tmn) & (tt < t_b) & (word >= 0))
                if blend_mode == BLEND_EXCLUDE:
                    h = h & ((word & FLAG_BLEND) == 0)
                elif blend_mode == BLEND_ONLY:
                    h = h & ((word & FLAG_BLEND) != 0)
                if cull_sign:
                    culled = (det * cull_sign < 0.0) & ((word & FLAG_DOUBLE_SIDED) == 0) & l_cull
                    h = h & ~culled
                t_b = torch.where(h, torch.where(l_any, torch.full_like(tt, NEG_BIG), tt), t_b)
                u_b = torch.where(h, uu, u_b)
                v_b = torch.where(h, vv, v_b)
                w_b = torch.where(h, word, w_b)
                retired = retired | (h & l_any)
            t_best[la], u_best[la], v_best[la], w_best[la] = t_b, u_b, v_b, w_b
            sp[la[retired]] = 0

    return t_best, w_best, u_best, v_best
