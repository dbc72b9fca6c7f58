"""The reference's ray casts: a binary BVH of its own and a plain PyTorch
traversal with a stack per ray.

The tree splits each node at the median centroid along the longest axis
of its centroid bounds, level by level (one stable sort a level), down to
leaves of at most LEAF triangles. A closest-hit cast returns, for each ray,
the triangle with the smallest t in (t_min, t_max), tested by the same
Moller-Trumbore arithmetic the renderer's traversal uses (p0, e1 = p1 - p0,
e2 = p2 - p0; det, u, v, t in the same order), so t, u and v are the
renderer's to the bit and only exact ties may resolve to another triangle.
An any-hit cast says whether any triangle lies in (t_min, t_max).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

LEAF = 8


class Tree(NamedTuple):
    lo: Any          # (N, 3) node boxes
    hi: Any
    left: Any        # (N,) i64 children, -1 for a leaf
    right: Any
    leaf_tris: Any   # (N, LEAF) i64 triangle ids, -1 padding (internal rows all -1)
    p0: Any          # (T, 3) triangle tables
    e1: Any
    e2: Any
    depth: int


def build(p0, p1, p2, device) -> Tree:
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    n_tri = p0.shape[0]
    lo_t = np.minimum(np.minimum(p0, p1), p2)
    hi_t = np.maximum(np.maximum(p0, p1), p2)
    cen = 0.5 * (lo_t + hi_t)
    order = np.arange(n_tri)
    start, count, left, right, level = [0], [n_tri], [-1], [-1], [0]
    frontier = [0]
    depth = 0
    while frontier:
        split = [n for n in frontier if count[n] > LEAF]
        if not split:
            break
        depth += 1
        starts = np.asarray([start[n] for n in split])
        counts = np.asarray([count[n] for n in split])
        pos = np.concatenate([np.arange(s, s + c) for s, c in zip(starts, counts)])
        seg = np.repeat(np.arange(len(split)), counts)
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        c = cen[order[pos]]
        ext = np.maximum.reduceat(c, offs) - np.minimum.reduceat(c, offs)
        axis = np.argmax(ext, 1)
        key = c[np.arange(len(pos)), axis[seg]]
        perm = np.lexsort((key, seg))
        order[pos] = order[pos][perm]
        frontier = []
        for n, s, k in zip(split, starts, counts):
            half = int(k) // 2
            for cs, cc in ((s, half), (s + half, k - half)):
                start.append(int(cs))
                count.append(int(cc))
                left.append(-1)
                right.append(-1)
                level.append(depth)
                frontier.append(len(start) - 1)
            left[n], right[n] = len(start) - 2, len(start) - 1
    n_nodes = len(start)
    start = np.asarray(start)
    count = np.asarray(count)
    left = np.asarray(left)
    right = np.asarray(right)
    level = np.asarray(level)
    is_leaf = left < 0
    lo = np.zeros((n_nodes, 3), np.float32)
    hi = np.zeros((n_nodes, 3), np.float32)
    leaves = np.nonzero(is_leaf)[0]
    leaves = leaves[np.argsort(start[leaves])]
    lo[leaves] = np.minimum.reduceat(lo_t[order], start[leaves])
    hi[leaves] = np.maximum.reduceat(hi_t[order], start[leaves])
    for lv in range(depth - 1, -1, -1):
        inner = np.nonzero((level == lv) & ~is_leaf)[0]
        lo[inner] = np.minimum(lo[left[inner]], lo[right[inner]])
        hi[inner] = np.maximum(hi[left[inner]], hi[right[inner]])
    leaf_tris = np.full((n_nodes, LEAF), -1, np.int64)
    for j in range(LEAF):
        has = is_leaf & (count > j)
        leaf_tris[has, j] = order[start[has] + j]

    def dev(a):
        return torch.as_tensor(a, device=device)

    return Tree(lo=dev(lo), hi=dev(hi), left=dev(left), right=dev(right),
                leaf_tris=dev(leaf_tris), p0=dev(p0), e1=dev(p1 - p0), e2=dev(p2 - p0),
                depth=depth)


def _inv_dir(d):
    big = 1e30
    return torch.where(torch.abs(d) > 1e-20, torch.reciprocal(d), torch.sign(d) * big + big)


def _box(tree, node, o, inv, t_min, t_best):
    """Entry distance and hit of the rays against the nodes' boxes."""
    t0 = (tree.lo[node] - o) * inv
    t1 = (tree.hi[node] - o) * inv
    tn = torch.amax(torch.minimum(t0, t1), -1)
    tf = torch.amin(torch.maximum(t0, t1), -1)
    return tn, (tf >= torch.maximum(tn, t_min)) & (tn <= t_best)


def cast(tree: Tree, origin, direction, t_min, t_max, any_hit: bool = False):
    """Closest hit (t, tri, u, v) of each ray, t = t_max and tri = -1 on a
    miss; with any_hit, tri >= 0 marks a ray that meets some triangle."""
    dev = origin.device
    r = origin.shape[0]
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev), (r,))
    inv = _inv_dir(direction)
    t_best = t_max.clone()
    tri_best = torch.full((r,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros(r, dtype=torch.float32, device=dev)
    v_best = torch.zeros(r, dtype=torch.float32, device=dev)
    stack = torch.zeros((r, tree.depth + 2), dtype=torch.int64, device=dev)
    sp = (t_min <= t_max).to(torch.int64)
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        node = stack[act, sp[act]]
        leaf = tree.left[node] < 0
        ia, n = act[~leaf], node[~leaf]
        if ia.numel():
            o, iv, tmn, tb = origin[ia], inv[ia], t_min[ia], t_best[ia]
            lc, rc = tree.left[n], tree.right[n]
            tl, hl = _box(tree, lc, o, iv, tmn, tb)
            tr, hr = _box(tree, rc, o, iv, tmn, tb)
            first_l = tl <= tr
            near = torch.where(first_l, lc, rc)
            far = torch.where(first_l, rc, lc)
            h_near = torch.where(first_l, hl, hr)
            h_far = torch.where(first_l, hr, hl)
            s = sp[ia]
            stack[ia[h_far], s[h_far]] = far[h_far]
            s = s + h_far.to(torch.int64)
            stack[ia[h_near], s[h_near]] = near[h_near]
            sp[ia] = s + h_near.to(torch.int64)
        la = act[leaf]
        if la.numel():
            tris = tree.leaf_tris[node[leaf]]                       # (k, L)
            ok = tris >= 0
            tc = torch.clamp(tris, min=0)
            p0, e1, e2 = tree.p0[tc], tree.e1[tc], tree.e2[tc]     # (k, L, 3)
            o = origin[la].unsqueeze(1)
            d = direction[la].unsqueeze(1)
            ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
            dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
            p0x, p0y, p0z = p0[..., 0], p0[..., 1], p0[..., 2]
            e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
            e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
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
            tb = t_best[la]
            h = (ok & det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                 & (tt > t_min[la].unsqueeze(1)) & (tt < tb.unsqueeze(1)))
            tt = torch.where(h, tt, torch.full_like(tt, float("inf")))
            t_leaf, j = torch.min(tt, 1)
            better = t_leaf < tb
            sel = la[better]
            jb = j[better].unsqueeze(1)
            t_best[sel] = t_leaf[better]
            tri_best[sel] = torch.gather(tris[better], 1, jb).squeeze(1)
            u_best[sel] = torch.gather(uu[better], 1, jb).squeeze(1)
            v_best[sel] = torch.gather(vv[better], 1, jb).squeeze(1)
            if any_hit:
                sp[sel] = 0
    return t_best, tri_best, u_best, v_best
