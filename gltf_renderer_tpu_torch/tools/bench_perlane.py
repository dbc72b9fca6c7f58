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
"""

from __future__ import annotations

import numpy as np
import torch

from gltf_renderer_tpu_torch.device import cuda_ms, resolve
from gltf_renderer_tpu_torch.ops import perlane
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


def main(device="cuda"):
    """Both fetches at every shape. Returns one dict per (kind, shape):
    kind, label, n, c, ms per call (None on the CPU) and us_step."""
    dev = resolve(device)
    on_card = dev.type == "cuda"
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}, "
          f"{STEPS} dependent steps per call", flush=True)
    rng = np.random.RandomState(0)
    rows = []

    def report(kind, label, n, c, fn, unit):
        ms = cuda_ms(fn, 16, warmup=2) if on_card else None
        if ms is None:
            out = fn()
            print(f"  {label:14s} ({n:5d}x{c:3d}): acc sum {float(out.sum()):.6g} "
                  f"(no time on the CPU)", flush=True)
            rows.append({"kind": kind, "label": label, "n": n, "c": c, "ms": None,
                         "us_step": None})
            return
        us = ms * 1e3 / STEPS
        extra = f" -> x{ROWS} rows = {us * ROWS:8.3f} us/packet-step" if kind == "shuffle" else ""
        print(f"  {label:14s} ({n:5d}x{c:3d}): {us:8.3f} us/step{unit}{extra}", flush=True)
        rows.append({"kind": kind, "label": label, "n": n, "c": c, "ms": ms, "us_step": us})

    print(f"\n=== A. onehot_fetch ({ROWS * LANES}-lane packet, 8 columns a step) ===")
    for label, n, c in SHAPES:
        ids, table = onehot_inputs(rng, n, c, dev)
        report("onehot", label, n, c, lambda: perlane.onehot_fetch(ids, table, STEPS), "")

    print(f"\n=== B. shuffle_fetch (one {LANES}-lane row, c columns a step) ===")
    for label, n, c in SHAPES:
        ids, table = shuffle_inputs(rng, n, c, dev)
        report("shuffle", label, n, c,
               lambda: perlane.shuffle_fetch(ids, table, n, c, STEPS), "/row")
    return rows


if __name__ == "__main__":
    main()
