"""The readings a cell's limits are set from, in one process on the chip.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> --control-seeds <k>
        --base-seed <s> [--seconds <run_seconds>] [--out <file.json>]

Lower readings: n whole runs of the cell (set-up, measured window, check)
on seeds base, base + 1, ...; each run's compared numbers. Upper readings:
the control on k more seeds: the configuration's reference put in the
program's place as its `build_scene(..., control=True)` builds it (the
default reference: its hit-attribute rows, normals, tangents and UVs,
rounded to bfloat16, the nearest precision below the configuration's
float32), over as many frames as the program's runs drew, against the same
reference in full precision. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--base-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import check, frames, harness, spec

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    cell = spec.load_cell(args.workload)
    runs = []
    for k in range(args.seeds):
        seed = args.base_seed + k
        t = time.perf_counter()
        res, _ = harness.run_cell(cell, seed, seconds, False)
        runs.append({"seed": seed, "frames": res["attempted"],
                     "numbers": {c: v["value"] for c, v in res["checks"].items()},
                     "correct": res["correct"], "metrics": res["metrics"],
                     "seconds": time.perf_counter() - t})
        print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    n_frames = int(statistics.median([r["frames"] for r in runs])) if runs else 30
    scene, sky = harness.make_inputs(cell)
    cfg = cell.config
    cam = cfg["camera"]
    controls = []
    for k in range(args.control_seeds):
        seed = args.base_seed + 1000 + k
        traffic = frames.Traffic(cell.traffic, seed)
        total = traffic.warm_frames + n_frames
        seeds = [traffic.frame_seed(i) for i in range(total)]
        w2v = harness.ref_pt.look_at(cam["eye"], cam["target"])
        px, py = check.sample_pixels(seed, cfg["width"], cfg["height"],
                                     int(cell.limits["pixels"]))
        t = time.perf_counter()
        nums = harness.reference_numbers(cell, scene, sky, w2v, seeds, total - 1, px, py,
                                         None, None, "cuda", control=True)
        controls.append({"seed": seed, "frames": n_frames, "numbers": nums,
                         "seconds": time.perf_counter() - t})
        print(json.dumps(controls[-1]), file=sys.stderr, flush=True)
    keys = list(cell.limits["limits"])
    summary = {k: {"lower": max(r["numbers"][k] for r in runs) if runs else None,
                   "upper": min(c["numbers"][k] for c in controls) if controls else None}
               for k in keys}
    out = {"workload": args.workload, "runs": runs, "controls": controls, "summary": summary,
           "all_correct": all(r["correct"] for r in runs),
           "rate": [r["metrics"]["pt_msamples_per_s"]["value"] for r in runs]}
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
