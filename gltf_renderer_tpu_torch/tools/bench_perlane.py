"""Per-lane row fetch on one CUDA card: microseconds per dependent step.

    python -m gltf_renderer_tpu_torch.tools.bench_perlane

Port of tools/bench_perlane.py's `main`. A per-lane BVH step has to fetch
each lane's node row; this tool times a chain of STEPS dependent fetches
at the real table shapes (helmet and courtyard node and leaf tables of the
16-wide collapse) through the two kernels of ops/perlane.py:

A. `onehot_fetch`: a 2048-lane packet summing 8 columns of its (n, c) bf16
   rows (on the TPU a one-hot matrix product);
B. `shuffle_fetch`: one 128-lane row fetching c values from the grouped
   (ceil(n/128) * c, 128) f32 table (on the TPU a group scan), also shown
   x 16 rows for a whole packet.

Times are CUDA events over 16 calls after 2 warm ones. The TPU tool's
printed break-even budgets were TPU numbers and are not carried over. On the
CPU the plain versions run once per shape and no time is printed.

Both kernels are chains of STEPS dependent loads, so what bounds them is
the latency of those loads, not bytes over the memory rate. A load hits L2
(the tables stay there between calls) or, where its SM fetched that line
before, L1. `hit_latency_ns` measures both latencies on the card with a
pointer chase (csrc/perlane.cu's `chase_latency_launch`). `l1_hit_ceiling`
counts, from the plain version's id chains on the same inputs, the largest
share of a call's dependent loads that can hit L1: every line a block
touches misses once (L1 starts each launch empty and is the SM's own; each
block is taken to have its SM to itself, as 16 onehot blocks on a
132-SM card do, and every shuffle block's chains touch the same lines).
`main` gives each row its floor, `latency_floor_ms` = STEPS x (h x L1 +
(1 - h) x L2) with h that ceiling: the least mean time of a lane's chain.
"""

from __future__ import annotations

import numpy as np
import torch

from gltf_renderer_tpu_torch.device import cuda_ms, resolve
from gltf_renderer_tpu_torch.ops import _build, perlane
from gltf_renderer_tpu_torch.ops.perlane import LANES, ROWS

STEPS = 32
# (label, n_rows, n_cols): the 16-wide tables' shapes from tools/perlane_study.py.
SHAPES = (
    ("helmet-node", 768, 112),
    ("helmet-leaf", 4480, 160),
    ("courtyard-node", 6400, 112),
)


def onehot_inputs(rng, n, c, device):
    """(ids (16, 128) int32, table (n, c) bf16) from a numpy RandomState."""
    ids = torch.from_numpy(rng.randint(0, n, (ROWS, LANES)).astype(np.int32)).to(device)
    table = torch.from_numpy(rng.rand(n, c).astype(np.float32)).to(device, torch.bfloat16)
    return ids, table


def shuffle_inputs(rng, n, c, device):
    """(ids (1, 128) int32, table (ceil(n/128) * c, 128) f32)."""
    ids = torch.from_numpy(rng.randint(0, n, (1, LANES)).astype(np.int32)).to(device)
    table = torch.from_numpy(rng.rand(-(-n // LANES) * c, LANES).astype(np.float32)).to(device)
    return ids, table


CHASE_LINES = {"l1": 1 << 8, "l2": 1 << 15}  # 128-byte lines: 32 KB inside L1; 4 MB above it
CHASE_STEPS = 1 << 14
LINE_BYTES = 128
ONEHOT_BLOCK = 128  # lanes of one onehot_fetch block (csrc/perlane.cu)


def hit_latency_ns(device="cuda", level: str = "l2", steps: int = CHASE_STEPS) -> float:
    """Nanoseconds a dependent load takes when it hits `level` ("l1" or
    "l2"), on the CUDA device: one thread follows `steps` links of a random
    cycle over CHASE_LINES[level] 128-byte lines (one int used a line), a
    first pass bringing them into the cache, the second timed on the card's
    global timer; L1 through ld.global.ca, L2 through ld.global.cg."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"the {level} latency is measured on a CUDA device, got {dev}")
    lines = CHASE_LINES[level]
    order = np.random.RandomState(1).permutation(lines).astype(np.int64) * 32
    chain = np.zeros(lines * 32, np.int32)
    chain[order] = np.roll(order, -1)
    chain_t = torch.from_numpy(chain).to(dev)
    ns = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(2, dtype=torch.int32, device=dev)
    fn = _build.entry("perlane.cu", "chase_latency_launch",
                      [_build.VP, _build.CI, _build.CI, _build.VP, _build.VP, _build.VP])
    _build.launch(fn, "chase_latency", dev.index, chain_t.data_ptr(), int(steps),
                  int(level == "l1"), ns.data_ptr(), sink.data_ptr())
    return float(ns.item()) / steps


def l1_hit_ceiling(kind, ids, table, n, c, steps: int = STEPS) -> float:
    """The largest share of a call's dependent loads that can hit L1, on
    these inputs: 1 - (the lines each block's chains touch, summed over
    blocks) / (the dependent loads). onehot: a load is a lane's row (its
    first 8 bf16 lie in one line), blocks of ONEHOT_BLOCK lanes; shuffle:
    the load that feeds the next id is column 0 of the lane's group, the
    same lines for every block. Chains from `perlane.chain_ids`."""
    idv = perlane.chain_ids(kind, ids, table, n, c, steps).long()
    if kind == "onehot":
        line = idv * (c * table.element_size()) // LINE_BYTES
        block = torch.arange(line.shape[1], device=line.device) // ONEHOT_BLOCK
    else:
        word = torch.div(idv, LANES, rounding_mode="floor") * c * LANES + idv % LANES
        line = word * table.element_size() // LINE_BYTES
        block = torch.zeros(line.shape[1], dtype=torch.int64, device=line.device)
    tagged = block[None, :] * (line.max() + 1) + line
    return 1.0 - torch.unique(tagged).numel() / tagged.numel()


def main(device="cuda"):
    """Both fetches at every shape. Returns one dict per (kind, shape):
    kind, label, n, c, l1_hit_ceiling, ms per call, us_step and
    latency_floor_ms (the last three None on the CPU)."""
    dev = resolve(device)
    on_card = dev.type == "cuda"
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}, "
          f"{STEPS} dependent steps per call", flush=True)
    rng = np.random.RandomState(0)
    rows = []
    lat = {}
    if on_card:
        lat = {level: hit_latency_ns(dev, level) for level in ("l1", "l2")}
        print(f"hit latency (pointer chase, {CHASE_STEPS} loads): L1 {lat['l1']:.1f} ns, "
              f"L2 {lat['l2']:.1f} ns; a {STEPS}-step chain takes at least "
              f"{STEPS * lat['l1'] * 1e-3:.3f} us (all L1) to {STEPS * lat['l2'] * 1e-3:.3f} us "
              f"(all L2)", flush=True)

    def report(kind, label, n, c, fn, unit, ids, table):
        h = l1_hit_ceiling(kind, ids, table, n, c)
        row = {"kind": kind, "label": label, "n": n, "c": c, "l1_hit_ceiling": h, "ms": None,
               "us_step": None, "latency_floor_ms": None}
        rows.append(row)
        if not on_card:
            out = fn()
            print(f"  {label:14s} ({n:5d}x{c:3d}): acc sum {float(out.sum()):.6g} "
                  f"(no time on the CPU)", flush=True)
            return
        ms = cuda_ms(fn, 16, warmup=2)
        us = ms * 1e3 / STEPS
        floor_ms = STEPS * (h * lat["l1"] + (1.0 - h) * lat["l2"]) * 1e-6
        row.update(ms=ms, us_step=us, latency_floor_ms=floor_ms)
        extra = f" -> x{ROWS} rows = {us * ROWS:8.3f} us/packet-step" if kind == "shuffle" else ""
        print(f"  {label:14s} ({n:5d}x{c:3d}): {us:8.3f} us/step{unit}{extra}; latency floor "
              f"{floor_ms * 1e3:.3f} us (at most {h:.3f} of its loads hit L1)", flush=True)

    print(f"\n=== A. onehot_fetch ({ROWS * LANES}-lane packet, 8 columns a step) ===")
    for label, n, c in SHAPES:
        ids, table = onehot_inputs(rng, n, c, dev)
        report("onehot", label, n, c, lambda: perlane.onehot_fetch(ids, table, STEPS), "",
               ids, table)

    print(f"\n=== B. shuffle_fetch (one {LANES}-lane row, c columns a step) ===")
    for label, n, c in SHAPES:
        ids, table = shuffle_inputs(rng, n, c, dev)
        report("shuffle", label, n, c,
               lambda: perlane.shuffle_fetch(ids, table, n, c, STEPS), "/row", ids, table)
    return rows


if __name__ == "__main__":
    main()
