"""Run one cell of BENCHMARK.json and print its result as one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without enough CUDA devices for the
cell, when the program cannot be imported, or when JAX or the JAX package
was loaded in this process. The compared numbers and their limits are the
last lines on standard error and the last key of the result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gltf_renderer_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them: a card
    set below its maximum runs slower under load."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"
    return out.splitlines()[0] if out else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from perfbench.harness import run_cell

    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = {"power_limit": power_limit()}
    result["checks"] = checks
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
