"""Peaks and the byte counts of the kernels' rooflines.

Peaks are the published figures of one card (NVIDIA's data sheet, SXM
part, dense rates) at its full power limit; a card set below it runs
slower under load, so the harness prints the limit beside each share.
"""

from __future__ import annotations

import math

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
}

RAY_IN_BYTES = 12 + 12 + 4 + 4   # origin, direction, t_min, t_max
LANE_MODE_BYTES = 4             # the any-hit lane flag of a merged launch
HIT_OUT_BYTES = 4 + 4 + 4 + 4   # t, u, v, word


def path_bytes(nodes, meta, records, words) -> int:
    """Bytes of one root-to-leaf path of K1's tree, from each table's
    (rows, columns, element bytes): a node row and its meta row at each
    level of a 4-wide tree over the leaves (ceil(log4(leaves)) levels,
    at least 1), and one leaf's record and word rows."""
    leaves = max(int(records[0]), 1)
    levels = max(math.ceil(math.log(leaves, 4)), 1)
    node_row = nodes[1] * nodes[2] + meta[1] * meta[2]
    leaf_row = records[1] * records[2] + words[1] * words[2]
    return levels * node_row + leaf_row


def k1_bytes(n_rays: int, has_mode: bool, table_bytes: int, path: int, live: int) -> int:
    """Bytes K1 (closest / any-hit BVH traversal) must move in one launch:
    each ray's inputs read once, each hit written once, and the node and
    leaf tables read once, but no more of them than the launch's `live`
    rays can reach: one root-to-leaf path (`path` bytes) a ray. An alpha
    hop launches every ray of its chunk with the finished ones dead
    (t_min > t_max), so it is not charged the whole tree."""
    per_ray = RAY_IN_BYTES + (LANE_MODE_BYTES if has_mode else 0) + HIT_OUT_BYTES
    tables = min(int(table_bytes), int(live) * int(path))
    return int(n_rays) * per_ray + tables


def peak(kind: str, name: str) -> float:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}: add them to perfbench/roofline.py")
    return PEAKS[kind][name]
