"""BVH build and table packing (host side, numpy).

Port of the host half of gltf_renderer_tpu/ops/bvh.py: the binned-SAH build
(`build`, native C++ builder loaded with ctypes, numpy fallback), the packed
leaf tables (`pack`) and the 4-wide node maps (`build_wide_maps`), and the
refresh of those tables for geometry that moves under a fixed topology
(`refit`, `pack_update`, and `assemble_wide` on tensors), which runs on the
tables' device. The traversal over these tables lives in ops/traverse.py.

The native builder is compiled from `native/bvh_builder.cpp` into the
port's build directory with portable flags, so the library runs on any x86
host; the committed `native/libgltf_native.so` is built with
`-march=native` for another machine and is not loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import sys
from typing import Any, NamedTuple

import numpy as np
import torch

log = logging.getLogger(__name__)

LEAF_SIZE = 16
SAH_BINS = 16

# Packed record row layout: LEAF_SIZE x [v0.xyz e1.xyz e2.xyz].
REC_GEO = 9 * LEAF_SIZE

# Id/flag word: tri_id | MASKED<<28 | BLEND<<29 | DOUBLE_SIDED<<30.
FLAG_MASKED = 1 << 28
FLAG_BLEND = 1 << 29
FLAG_DOUBLE_SIDED = 1 << 30
ID_MASK = (1 << 28) - 1

BLEND_ANY = 0       # no blend filtering
BLEND_EXCLUDE = 1   # opaque pass: skip BLEND-flagged triangles
BLEND_ONLY = 2      # blend pass: only BLEND-flagged triangles

# Wide (4-ary) meta words: internal -> wide child index; leaf -> compact
# leaf index | WIDE_LEAF_BIT.
WIDE_LEAF_BIT = 1 << 30
WIDE_ID_MASK = WIDE_LEAF_BIT - 1

# Empty-child sentinel: a far-away point box that no finite ray interval hits.
_EMPTY_BOX = np.full(6, 3.0e38, np.float32)

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_ext")
_NATIVE_SRC = os.path.join(_REPO_ROOT, "native", "bvh_builder.cpp")


class FlatBVH(NamedTuple):
    aabb_min: Any    # (N, 3) f32
    aabb_max: Any    # (N, 3) f32
    first: Any       # (N,) i32 — leaf: first slot in tri_order; internal: i+1
    count: Any       # (N,) i32 — leaf triangle count; 0 for internal nodes
    skip: Any        # (N,) i32 — node to visit on miss / after leaf (== N done)
    right: Any       # (N,) i32 — internal: right-child index; leaf: -1
    tri_order: Any   # (T,) i32 — BVH slot -> original triangle id
    levels: Any      # (N,) i32 — node depth


class PackedBVH(NamedTuple):
    nodes: Any     # (N, 8) f32: [lo.xyz, hi.xyz, leaf_first (or -1), skip]
    records: Any   # (N, REC_GEO) f32: LEAF_SIZE x [v0.xyz e1.xyz e2.xyz]
    words: Any     # (N, LEAF_SIZE) i32: id/flag words, -1 = empty slot
    n_nodes: int


class WideMaps(NamedTuple):
    child_src: Any   # (N4, 4) i32 — binary node id per child (-1 = empty)
    meta: Any        # (N4, 4) i32 — child meta words
    leaf_ids: Any = None  # (L,) i32 — binary node id of compact leaf l


def _build_recursive(lo, hi, centroid, order, leaf_size=LEAF_SIZE):
    """Binned-SAH DFS build in numpy (the reference's fallback builder)."""
    t = len(order)
    n_min, n_max, n_first, n_count, n_right, n_level = [], [], [], [], [], []
    sys.setrecursionlimit(max(10000, sys.getrecursionlimit()))

    def area(lo_a, hi_a):
        d = np.maximum(hi_a - lo_a, 0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    def build(begin, end, level):
        node = len(n_min)
        idx = order[begin:end]
        n_min.append(lo[idx].min(0))
        n_max.append(hi[idx].max(0))
        n_first.append(begin)
        n_count.append(0)
        n_right.append(-1)
        n_level.append(level)
        count = end - begin
        if count <= leaf_size:
            n_count[node] = count
            return node
        c = centroid[idx]
        c_lo, c_hi = c.min(0), c.max(0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))
        mid = -1
        best_cost = np.inf
        best_sel = None
        for ax in range(3):
            if extent[ax] <= 1e-12:
                continue
            scale = SAH_BINS * (1.0 - 1e-6) / extent[ax]
            bins = np.minimum(((c[:, ax] - c_lo[ax]) * scale).astype(np.int32), SAH_BINS - 1)
            bin_count = np.bincount(bins, minlength=SAH_BINS)
            bin_lo = np.full((SAH_BINS, 3), np.inf, np.float32)
            bin_hi = np.full((SAH_BINS, 3), -np.inf, np.float32)
            for b in np.nonzero(bin_count)[0]:
                mask = bins == b
                bin_lo[b] = lo[idx[mask]].min(0)
                bin_hi[b] = hi[idx[mask]].max(0)
            lc = np.cumsum(bin_count)[:-1]
            rc = count - lc
            l_lo = np.minimum.accumulate(bin_lo, 0)[:-1]
            l_hi = np.maximum.accumulate(bin_hi, 0)[:-1]
            r_lo = np.minimum.accumulate(bin_lo[::-1], 0)[::-1][1:]
            r_hi = np.maximum.accumulate(bin_hi[::-1], 0)[::-1][1:]
            cost = area(l_lo, l_hi) * lc + area(r_lo, r_hi) * rc
            cost = np.where((lc == 0) | (rc == 0), np.inf, cost)
            b_ax = int(np.argmin(cost))
            if np.isfinite(cost[b_ax]) and cost[b_ax] < best_cost:
                best_cost = float(cost[b_ax])
                best_sel = bins <= b_ax
        if best_sel is not None:
            left_idx = idx[best_sel]
            right_idx = idx[~best_sel]
            order[begin : begin + len(left_idx)] = left_idx
            order[begin + len(left_idx) : end] = right_idx
            mid = begin + len(left_idx)
        if mid <= begin or mid >= end:
            mid = begin + count // 2
            sel = np.argsort(c[:, axis], kind="stable")
            order[begin:end] = idx[sel]
        build(begin, mid, level + 1)
        right = build(mid, end, level + 1)
        n_first[node] = node + 1
        n_right[node] = right
        return node

    build(0, t, 0)
    n = len(n_min)
    skip = np.full(n, n, np.int32)
    stack = [(0, n)]
    while stack:
        nd, sv = stack.pop()
        skip[nd] = sv
        if n_count[nd] == 0:
            stack.append((nd + 1, n_right[nd]))
            stack.append((n_right[nd], sv))
    return (
        np.asarray(n_min, np.float32).reshape(n, 3),
        np.asarray(n_max, np.float32).reshape(n, 3),
        np.asarray(n_first, np.int32),
        np.asarray(n_count, np.int32),
        skip,
        np.asarray(n_right, np.int32),
        np.asarray(n_level, np.int32),
    )


_NATIVE = None
_NATIVE_TRIED = False


def host_library(src: str) -> ctypes.CDLL:
    """Compile the C++ source `src` with g++ into BUILD_DIR (once, the
    library named by the source's hash) and load it. Raises if g++ is
    missing or the build fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: cannot build {src}")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp, src],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(lib_path)


def _load_native():
    """Build (once, keyed by the source hash) and load the C++ SAH builder.

    Returns None when no C++ compiler is present; `build` then uses the
    numpy builder, which produces a tree of the same kind more slowly."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    if shutil.which("g++") is None:
        log.warning("g++ not found: building BVHs with the numpy builder")
        return None
    lib = host_library(_NATIVE_SRC)
    f_p = ctypes.POINTER(ctypes.c_float)
    i_p = ctypes.POINTER(ctypes.c_int32)
    lib.bvh_build.argtypes = [f_p, f_p, f_p, ctypes.c_int, ctypes.c_int,
                              f_p, f_p, i_p, i_p, i_p, i_p, i_p, i_p]
    lib.bvh_build.restype = ctypes.c_int
    _NATIVE = lib
    return _NATIVE


def _build_native(lib, v0, v1, v2, leaf_size=LEAF_SIZE) -> FlatBVH:
    t = len(v0)
    cap = 2 * t
    aabb_min = np.empty((cap, 3), np.float32)
    aabb_max = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    levels = np.empty(cap, np.int32)
    tri_order = np.empty(t, np.int32)
    v0c = np.ascontiguousarray(v0, np.float32)
    v1c = np.ascontiguousarray(v1, np.float32)
    v2c = np.ascontiguousarray(v2, np.float32)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    f = ctypes.c_float
    i = ctypes.c_int32
    n = lib.bvh_build(
        ptr(v0c, f), ptr(v1c, f), ptr(v2c, f), t, leaf_size,
        ptr(aabb_min, f), ptr(aabb_max, f), ptr(first, i), ptr(count, i),
        ptr(skip, i), ptr(right, i), ptr(levels, i), ptr(tri_order, i),
    )
    return FlatBVH(aabb_min[:n].copy(), aabb_max[:n].copy(), first[:n].copy(),
                   count[:n].copy(), skip[:n].copy(), right[:n].copy(), tri_order,
                   levels[:n].copy())


def build(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, use_native: bool = True,
          leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Build a threaded binned-SAH BVH (host). v0/v1/v2: (T, 3) vertices."""
    t = len(v0)
    if use_native and t > 0:
        lib = _load_native()
        if lib is not None:
            return _build_native(lib, v0, v1, v2, leaf_size)
    if t == 0:
        return FlatBVH(
            np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
            np.ones(1, np.int32), np.zeros(1, np.int32), np.ones(1, np.int32),
            np.full(1, -1, np.int32), np.zeros(0, np.int32), np.zeros(1, np.int32),
        )
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = ((lo + hi) * 0.5).astype(np.float32)
    order = np.arange(t, dtype=np.int32)
    n_min, n_max, first, count, skip, right, level = _build_recursive(
        lo, hi, centroid, order, leaf_size)
    return FlatBVH(n_min, n_max, first, count, skip, right, order, level)


def pack(bvh: FlatBVH, slot_v0, slot_e1, slot_e2, slot_flags) -> PackedBVH:
    """Packed node/record/word tables (host numpy). slot_* are in BVH slot
    order; slot_flags (T,) int32 carries FLAG_* bits ORed with the tri id."""
    n = int(np.asarray(bvh.count).shape[0])
    first = np.asarray(bvh.first)
    count = np.asarray(bvh.count)
    skip = np.asarray(bvh.skip)
    nodes = np.zeros((n, 8), np.float32)
    nodes[:, 0:3] = np.asarray(bvh.aabb_min)
    nodes[:, 3:6] = np.asarray(bvh.aabb_max)
    nodes[:, 6] = np.where(count > 0, first, -1).astype(np.float32)
    nodes[:, 7] = skip.astype(np.float32)
    t = len(slot_v0)
    records = np.zeros((n, REC_GEO), np.float32)
    words = np.full((n, LEAF_SIZE), -1, np.int32)
    if t:
        sv0 = np.asarray(slot_v0, np.float32)
        se1 = np.asarray(slot_e1, np.float32)
        se2 = np.asarray(slot_e2, np.float32)
        sfl = np.asarray(slot_flags, np.int32)
        ks = np.arange(LEAF_SIZE)
        slot = np.clip(first[:, None] + ks[None, :], 0, t - 1)
        for k in range(LEAF_SIZE):
            records[:, 9 * k : 9 * k + 3] = sv0[slot[:, k]]
            records[:, 9 * k + 3 : 9 * k + 6] = se1[slot[:, k]]
            records[:, 9 * k + 6 : 9 * k + 9] = se2[slot[:, k]]
        valid = (ks[None, :] < count[:, None]) & (count[:, None] > 0)
        words = np.where(valid, sfl[slot], np.int32(-1)).astype(np.int32)
    return PackedBVH(nodes=nodes, records=records, words=words, n_nodes=n)


def build_wide_maps(bvh: FlatBVH, width: int = 4) -> "tuple[WideMaps, int]":
    """Collapse the binary tree into 4-wide nodes (host). Returns
    (maps, root_meta); leaf meta entries carry compact leaf indices into
    maps.leaf_ids."""
    levels = {4: 2}[width]
    count = np.asarray(bvh.count)
    right = np.asarray(bvh.right)
    n = count.shape[0]
    if n == 0 or count[0] > 0:
        child_src = np.full((1, width), -1, np.int32)
        meta = np.full((1, width), WIDE_LEAF_BIT, np.int32)
        leaf_ids = np.zeros(max(n, 1), np.int32)
        if n:
            child_src[0, 0] = 0
            meta[0, 0] = 0 | WIDE_LEAF_BIT
        return WideMaps(child_src=child_src, meta=meta, leaf_ids=leaf_ids), 0

    def expand(b, depth):
        if count[b] > 0 or depth == 0:
            return [b]
        return expand(b + 1, depth - 1) + expand(right[b], depth - 1)

    def entries_of(b):
        return expand(b + 1, levels - 1) + expand(right[b], levels - 1)

    wide_id = {0: 0}
    order = [0]
    work = [0]
    children = {}
    while work:
        b = work.pop()
        ents = entries_of(b)
        children[b] = ents
        for e in ents:
            if count[e] == 0 and e not in wide_id:
                wide_id[e] = len(order)
                order.append(e)
                work.append(e)
    nw = len(order)
    child_src = np.full((nw, width), -1, np.int32)
    meta = np.full((nw, width), WIDE_LEAF_BIT, np.int32)
    leaf_idx = {}
    leaf_ids = []
    for w, b in enumerate(order):
        for c, e in enumerate(children[b]):
            child_src[w, c] = e
            if count[e] > 0:
                if e not in leaf_idx:
                    leaf_idx[e] = len(leaf_ids)
                    leaf_ids.append(e)
                meta[w, c] = np.int32(leaf_idx[e] | WIDE_LEAF_BIT)
            else:
                meta[w, c] = np.int32(wide_id[e])
    return WideMaps(child_src=child_src, meta=meta,
                    leaf_ids=np.asarray(leaf_ids or [0], np.int32)), 0


def assemble_wide(packed_nodes, child_src: np.ndarray):
    """(N4, 24) f32 wide box rows gathered from the binary node rows;
    empty children get the far-point sentinel box. A tensor `packed_nodes`
    (a refitted frame's) gives a tensor on its device with the same bits."""
    if isinstance(packed_nodes, torch.Tensor):
        dev = packed_nodes.device
        src = torch.as_tensor(np.asarray(child_src), device=dev).long()
        boxes = packed_nodes[src.clamp(min=0), 0:6]
        boxes = torch.where((src < 0)[..., None], torch.as_tensor(_EMPTY_BOX, device=dev), boxes)
        return boxes.reshape(src.shape[0], src.shape[1] * 6)
    src = np.asarray(child_src)
    boxes = np.asarray(packed_nodes)[np.clip(src, 0, None), 0:6]
    boxes = np.where((src < 0)[..., None], _EMPTY_BOX, boxes)
    return boxes.reshape(src.shape[0], src.shape[1] * 6).astype(np.float32)


def _leaf_slots(bvh: FlatBVH, t: int):
    """(N, LEAF_SIZE) slot ids of each node's triangles (clipped to the
    slot range) and which of them the node holds."""
    first = np.asarray(bvh.first)
    ks = np.arange(LEAF_SIZE)[None, :]
    slot = np.clip(first[:, None] + ks, 0, max(t - 1, 0))
    return slot, ks < np.asarray(bvh.count)[:, None]


def refit(bvh: FlatBVH, v0, v1, v2) -> FlatBVH:
    """Node boxes of the host tree `bvh` (static topology) around moved
    triangles, on the vertices' device (JAX ops/bvh.py:271): leaf boxes as
    the min / max over their LEAF_SIZE slots (padding +-inf), then internal
    nodes bottom-up by depth level, one gather and scatter a level. The
    host topology drives the loop; its index arrays go to the device in
    one upload.

    v0/v1/v2: (T, 3) tensors of the current vertices, original triangle
    order. Returns bvh with aabb_min / aabb_max tensors."""
    counts = np.asarray(bvh.count)
    levels = np.asarray(bvh.levels)
    rights = np.asarray(bvh.right)
    slot, valid = _leaf_slots(bvh, v0.shape[0])
    parts = [np.asarray(bvh.tri_order), slot, valid, counts > 0]
    for lev in range(int(levels.max()) - 1 if len(levels) else -1, -1, -1):
        sel = np.nonzero((levels == lev) & (counts == 0))[0]
        if len(sel):
            parts += [sel, sel + 1, rights[sel]]
    flat = torch.as_tensor(np.concatenate([np.asarray(x, np.int64).ravel() for x in parts]),
                           device=v0.device)
    ix = list(torch.split(flat, [int(np.asarray(x).size) for x in parts]))
    tri = ix[0]
    slot = ix[1].view(slot.shape)
    valid = ix[2].view(valid.shape) != 0
    is_leaf = ix[3][:, None] != 0
    t_lo = torch.minimum(torch.minimum(v0[tri], v1[tri]), v2[tri])
    t_hi = torch.maximum(torch.maximum(v0[tri], v1[tri]), v2[tri])
    inf = torch.tensor(float("inf"), device=v0.device)
    leaf_lo = torch.where(valid[..., None], t_lo[slot], inf).amin(1)
    leaf_hi = torch.where(valid[..., None], t_hi[slot], -inf).amax(1)
    lo = torch.where(is_leaf, leaf_lo, inf)
    hi = torch.where(is_leaf, leaf_hi, -inf)
    for sel, left, right in zip(ix[4::3], ix[5::3], ix[6::3]):
        lo[sel] = torch.minimum(lo[left], lo[right])
        hi[sel] = torch.maximum(hi[left], hi[right])
    return bvh._replace(aabb_min=lo, aabb_max=hi)


def pack_update(packed: PackedBVH, bvh_host: FlatBVH, slot_v0, slot_e1, slot_e2,
                refitted: FlatBVH = None) -> PackedBVH:
    """The packed tables of moved geometry (JAX ops/bvh.py:615), on the
    tensors' device: every node's LEAF_SIZE [v0, e1, e2] records gathered
    from the slot-order tensors as `pack` lays them out, and, given
    `refit`'s result, node boxes from it with columns 6-7 (leaf first,
    skip) kept. The id words and the topology do not change."""
    dev = slot_v0.device
    slot, _ = _leaf_slots(bvh_host, slot_v0.shape[0])
    slot = torch.as_tensor(slot, device=dev).long()
    records = torch.stack([slot_v0[slot], slot_e1[slot], slot_e2[slot]], 2)
    nodes = packed.nodes
    if refitted is not None:
        nodes = torch.cat([refitted.aabb_min, refitted.aabb_max,
                           torch.as_tensor(packed.nodes[:, 6:8], device=dev)], 1)
    return packed._replace(nodes=nodes, records=records.reshape(slot.shape[0], REC_GEO))


def wide_stack_bound(meta: np.ndarray, root_meta: int) -> int:
    """Most entries a depth-first traversal's stack can ever hold.

    A popped internal node pushes up to k = 4 child entries, nearest first
    on top, so any child may run first with up to k - 1 siblings waiting
    beneath it. So bound(node) = k - 1 + max_i bound(child_i), and a leaf
    entry needs 1 slot. Every child slot counts (empty ones too), so the
    bound holds whichever boxes a ray hits, in whichever order."""
    meta = np.asarray(meta)
    k = meta.shape[1]
    memo = {}
    # Children before parents: wide ids are assigned parents-first, so a
    # reverse sweep sees every internal child's bound before its parent's.
    for node in range(meta.shape[0] - 1, -1, -1):
        memo[node] = k - 1 + max(
            1 if int(e) & WIDE_LEAF_BIT else memo[int(e)] for e in meta[node]
        )
    root = int(root_meta)
    return 1 if root & WIDE_LEAF_BIT else memo[root]
