"""Per-lane row fetch on one CUDA card: microseconds per dependent step.

    python -m gltf_renderer_tpu_torch.tools.bench_perlane
    python -m gltf_renderer_tpu_torch.tools.bench_perlane --study [--parent OLD.cu]

Port of tools/bench_perlane.py's `main`. A per-lane BVH step has to fetch
each lane's node row; this tool times a chain of STEPS dependent fetches
at the real table shapes (helmet and courtyard node and leaf tables of the
16-wide collapse) through the two kernels of ops/perlane.py:

A. `onehot_fetch`: a 2048-lane packet summing 8 columns of its (n, c) bf16
   rows (on the TPU a one-hot matrix product);
B. `shuffle_fetch`: one 128-lane row fetching c values from the grouped
   (ceil(n/128) * c, 128) f32 table (on the TPU a group scan), also shown
   x 16 rows for a whole packet.

Times are CUDA events over 16 calls after 2 warm ones: launch-bound, they
time the wrapper and the launch more than the kernel. `--study` (`study`)
measures both kernels' device time a call instead, from CUDA-graph
replays, in turns with an older perlane.cu given by --parent, with a
steps sweep, clock samples and the SASS opcode counts; it prints one JSON
line last. The TPU tool's
printed break-even budgets were TPU numbers and are not carried over. On
the CPU the plain versions run once per shape and no time is printed.

Both kernels are chains of STEPS dependent loads, so what bounds them is
the latency of those loads, not bytes over the memory rate. Read in
place, a load hits L2 (the tables stay there between calls) or, where its
SM fetched that line before, L1; copied into shared memory first, every
load of the chain is a shared-memory load. `hit_latency_ns` measures the
three latencies on the card with a pointer chase (csrc/perlane.cu's
`chase_latency_launch`). `l1_hit_ceiling` counts, from the plain
version's id chains on the same inputs, the largest share of a call's
dependent loads that can hit L1: every line a block touches misses once
(L1 starts each launch empty and is the SM's own; each block is taken to
have its SM to itself, as the 8 onehot blocks of ONEHOT_BLOCK lanes on a
132-SM card do, and every shuffle block's chains touch the same lines).
`main` gives each row its floor, `latency_floor_ms`: the least mean time
of a lane's chain, read in place or staged, whichever is less
(`latency_floor_ns`).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from gltf_renderer_tpu_torch.device import (card_name_and_power_limit, cuda_ms, device_us_by_op,
                                            gpu_clocks, graph_of, replay_us, resolve)
from gltf_renderer_tpu_torch.ops import _build, perlane, warm
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


# Pointer chases: level -> (the chain's ints, the ints between two of its
# entries). L1: 256 128-byte lines, 32 KB inside L1; L2: 32,768 lines, 4 MB
# above L1; shared memory: 8,192 ints, every one an entry (32 KB).
CHASE = {"l1": (1 << 13, 32), "l2": (1 << 20, 32), "smem": (1 << 13, 1)}
CHASE_LEVEL = {"l2": 0, "l1": 1, "smem": 2}  # chase_latency_launch's `level`
CHASE_STEPS = 1 << 14
LINE_BYTES = 128
ONEHOT_BLOCK = _build.source_define("perlane.cu", "ONEHOT_THREADS")  # lanes of a onehot block


def chase_chain(level: str, seed: int = 1) -> np.ndarray:
    """CHASE[level]'s chain: int32, each entry holding the index of the
    next, all entries on one random cycle; the ints between entries are 0."""
    size, gap = CHASE[level]
    order = np.random.RandomState(seed).permutation(size // gap).astype(np.int64) * gap
    chain = np.zeros(size, np.int32)
    chain[order] = np.roll(order, -1)
    return chain


def hit_latency_ns(device="cuda", level: str = "l2", steps: int = CHASE_STEPS,
                   lanes: int = 1) -> float:
    """Nanoseconds a dependent load takes when it hits `level` ("l1", "l2"
    or "smem"), on the CUDA device: `lanes` threads of one warp follow
    `steps` links of `chase_chain(level)` from evenly spaced starts, a first
    pass bringing the lines into the cache, the second timed on the card's
    global timer; L1 through ld.global.ca, L2 through ld.global.cg, shared
    memory after a copy of the chain into it. With 32 lanes each shared
    load also pays the bank conflicts of 32 scattered words."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"the {level} latency is measured on a CUDA device, got {dev}")
    chain = torch.from_numpy(chase_chain(level)).to(dev)
    ns = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(2 * lanes, dtype=torch.int32, device=dev)
    fn = _build.entry("perlane.cu", "chase_latency_launch",
                      [_build.VP] + [_build.CI] * 4 + [_build.VP] * 3)
    _build.launch(fn, "chase_latency", chain.device.index, chain.data_ptr(), chain.numel(),
                  int(steps), CHASE_LEVEL[level], int(lanes), ns.data_ptr(), sink.data_ptr())
    return float(ns.item()) / steps


def latency_floor_ns(h: float, lat: dict, steps: int = STEPS) -> float:
    """The least time of one lane's chain of `steps` dependent loads, from
    the hit latencies `lat` (ns; "l1", "l2", "smem" as `hit_latency_ns`
    measures them with one lane): read in place, steps x (h x L1 + (1 - h)
    x L2), h the share of loads that can hit L1; staged, one L2 round trip
    (the copy into shared memory) and then steps shared-memory loads. The
    smaller of the two. Bank conflicts are not counted: they depend on the
    design's layout, not on the work."""
    in_place = steps * (h * lat["l1"] + (1.0 - h) * lat["l2"])
    return min(in_place, lat["l2"] + steps * lat["smem"])


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
    kind, label, n, c, l1_hit_ceiling, ms per call, us_step,
    latency_floor_ms (the last three None on the CPU) and, on the card,
    hit_latency_ns (the chases' latencies)."""
    dev = resolve(device)
    on_card = dev.type == "cuda"
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}, "
          f"{STEPS} dependent steps per call", flush=True)
    rng = np.random.RandomState(0)
    rows = []
    lat = {}
    if on_card:
        lat = {level: hit_latency_ns(dev, level) for level in CHASE}
        lat["smem_warp"] = hit_latency_ns(dev, "smem", lanes=32)
        print(f"hit latency (pointer chase, {CHASE_STEPS} loads): L1 {lat['l1']:.1f} ns, "
              f"L2 {lat['l2']:.1f} ns, shared memory {lat['smem']:.1f} ns (one lane; "
              f"{lat['smem_warp']:.1f} ns for 32 lanes at scattered words); a {STEPS}-step "
              f"chain takes at least {STEPS * lat['l1'] * 1e-3:.3f} us (all L1) to "
              f"{STEPS * lat['l2'] * 1e-3:.3f} us (all L2) in place, "
              f"{(lat['l2'] + STEPS * lat['smem']) * 1e-3:.3f} us staged", flush=True)

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
        floor_ms = latency_floor_ns(h, lat) * 1e-6
        row.update(ms=ms, us_step=us, latency_floor_ms=floor_ms, hit_latency_ns=lat)
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


SWEEP_STEPS = (1, 2, 4, 8, 16, 32, 64)
SWEEP_SHAPE = SHAPES[-1]  # 6400x112
GRAPH_LAUNCHES = 64
KINDS = ("onehot", "shuffle")


def runner(kind, source=None):
    """A function (ids, table, n, c, steps) -> acc through `kind`'s kernel
    ("onehot" or "shuffle"): the wrapper (counted) when `source` is None,
    else the launcher of the perlane.cu at path `source`, an older version
    with the same argument list, uncounted."""
    if source is None:
        if kind == "onehot":
            return lambda ids, table, n, c, steps: perlane.onehot_fetch(ids, table, steps)
        return perlane.shuffle_fetch
    fn = getattr(_build.load(os.path.abspath(source)), f"{kind}_fetch_launch")
    fn.argtypes = [_build.VP, _build.VP] + [_build.CI] * 4 + [_build.VP] * 2  # both launchers
    fn.restype = _build.CI

    def run(ids, table, n, c, steps):
        if kind == "onehot":
            out = torch.empty((ROWS, LANES), dtype=torch.float32, device=ids.device)
            ints = (n, c, int(steps), ids.numel())
        else:
            out = torch.empty((c, LANES), dtype=torch.float32, device=ids.device)
            ints = (n, c, -(-n // LANES), int(steps))
        _build.launch(fn, f"parent {kind}_fetch", ids.device.index, ids.data_ptr(),
                      table.data_ptr(), *ints, out.data_ptr())
        return out

    return run


def fit_line(xs, ys):
    """(slope, intercept) of the least-squares line through (xs, ys)."""
    slope, intercept = np.polyfit(np.asarray(xs, np.float64), np.asarray(ys, np.float64), 1)
    return float(slope), float(intercept)


def kernel_opcodes(source, name: str) -> dict:
    """{mangled name: {opcode: count}} of the SASS of every function of
    csrc/<source> (or a path) whose name holds `name`."""
    out = {}
    for fname, lines in _build.sass(source).items():
        if name in fname:
            ops = [_build.opcode(x) for x in lines]
            out[fname] = {op: ops.count(op) for op in sorted(set(ops))}
    return out


def clock_under_load(graph, replays: int = 2000) -> str:
    """`gpu_clocks` read while `replays` replays of `graph` queued back to
    back still run."""
    for _ in range(replays):
        graph.replay()
    sample = gpu_clocks()
    torch.cuda.synchronize()
    return sample


def _kernel_us(by_op: dict, name: str) -> list:
    """[device us a launch, launches recorded] of the kernel `name` from
    `device_us_by_op`; [None, 0] where the profiler recorded none."""
    return next(([us, n] for k, (us, n) in by_op.items() if name in k), [None, 0])


def format_numbers(numbers: dict, places: int = 3) -> str:
    """"key value, ..." of a dict of numbers and lists of numbers, each
    rounded to `places`; None, a reading the profiler did not record, is
    written "not recorded"."""
    def one(x):
        if isinstance(x, (list, tuple)):
            return "[" + ", ".join(one(y) for y in x) + "]"
        return "not recorded" if x is None else str(round(x, places))
    return ", ".join(f"{k} {one(v)}" for k, v in numbers.items())


def _inputs(kind, rng, n, c, dev):
    return (onehot_inputs if kind == "onehot" else shuffle_inputs)(rng, n, c, dev)


def _ref(kind, ids, table, n, c, steps):
    if kind == "onehot":
        return perlane.onehot_fetch_ref(ids, table, steps)
    return perlane.shuffle_fetch_ref(ids, table, n, c, steps)




def study(device="cuda", parent=None):
    """K4's and K5's device time on the card, each in turns with the older
    kernel at path `parent` when given (parent, new, new, parent): at
    every shape, the
    graph-replay device time a call (GRAPH_LAUNCHES launches captured in
    one CUDA graph) and torch.profiler's; the same over SWEEP_STEPS at
    SWEEP_SHAPE with each kernel's fitted slope (ns a step) and intercept
    (us), and its time at 0 steps (launch, staging and store only); K6's
    graph-replay time (`warm.add_one`, 8x128) beside the intercepts; the SM
    clock idle and under load; each kernel's SASS opcode counts. Every
    kernel's output is held to the plain version first. Returns a dict (the
    JSON line): {"onehot": {"shapes", "sweep"}, "shuffle": {...},
    "k6_graph_us", "k6_profiler_us", "clocks_idle", "clocks_load", "sass",
    "card"}."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"the per-lane study runs on a CUDA device, got {dev}")
    res = {"card": card_name_and_power_limit(), "clocks_idle": gpu_clocks()}
    rng = np.random.RandomState(0)
    load_graph = None
    for kind in KINDS:
        runs = {"parent": runner(kind, parent)} if parent else {}
        runs["new"] = runner(kind)
        tag = "k4" if kind == "onehot" else "k5"
        shapes, sweeps = {}, {}
        for label, n, c in SHAPES:
            ids, table = _inputs(kind, rng, n, c, dev)
            want = _ref(kind, ids, table, n, c, STEPS)
            graphs, row = {}, {}
            for k, run in runs.items():
                def call(run=run):
                    return run(ids, table, n, c, STEPS)
                if not bool(torch.equal(call().view(torch.int32), want.view(torch.int32))):
                    raise AssertionError(f"the {k} {kind} kernel disagrees with its plain "
                                         f"version at {label}")
                graphs[k] = graph_of(call, GRAPH_LAUNCHES)
                row[f"{k}_profiler_us"] = _kernel_us(device_us_by_op(call), f"{kind}_fetch")
            order = list(graphs) + list(graphs)[::-1]
            for k in order:
                row.setdefault(f"{k}_graph_us", []).append(replay_us(graphs[k], GRAPH_LAUNCHES))
            shapes[label] = row
            print(f"[{tag}] {label} ({n}x{c}): {format_numbers(row)} (us; profiler: [us a "
                  f"launch, launches recorded of 10])", flush=True)
        label, n, c = SWEEP_SHAPE
        ids, table = _inputs(kind, rng, n, c, dev)
        for k, run in runs.items():
            sweep = {}
            for steps in SWEEP_STEPS:
                def call(run=run, steps=steps):
                    return run(ids, table, n, c, steps)
                g = graph_of(call, GRAPH_LAUNCHES)
                sweep[steps] = replay_us(g, GRAPH_LAUNCHES)
                if steps == STEPS and kind == "shuffle":
                    load_graph = g
            slope, icpt = fit_line(list(sweep), list(sweep.values()))
            zero = replay_us(graph_of(lambda run=run: run(ids, table, n, c, 0), GRAPH_LAUNCHES),
                             GRAPH_LAUNCHES)
            sweeps[k] = {"us": sweep, "slope_ns": slope * 1e3, "intercept_us": icpt,
                         "steps0_us": zero}
            print(f"[{tag}] sweep {k} at {label}: "
                  + ", ".join(f"{s}: {v:.3f}" for s, v in sweep.items())
                  + f" us; slope {slope * 1e3:.2f} ns a step, intercept {icpt:.3f} us; 0 steps "
                  f"(launch, staging, store) {zero:.3f} us", flush=True)
        res[kind] = {"shapes": shapes, "sweep": sweeps}
    x = torch.zeros(warm.WARM_SHAPE, dtype=torch.float32, device=dev)
    res["k6_graph_us"] = replay_us(graph_of(lambda: warm.add_one(x), GRAPH_LAUNCHES),
                                   GRAPH_LAUNCHES)
    res["k6_profiler_us"] = _kernel_us(device_us_by_op(lambda: warm.add_one(x)), "add_one")
    res["clocks_load"] = clock_under_load(load_graph)
    print(f"[study] K6 graph {res['k6_graph_us']:.3f} us, "
          f"{format_numbers({'profiler': res['k6_profiler_us']})} "
          f"[us, launches recorded of 10]; clocks idle {res['clocks_idle']} | under load "
          f"{res['clocks_load']}", flush=True)
    res["sass"] = {}
    for k, src in (("parent", parent and os.path.abspath(parent)), ("new", "perlane.cu")):
        if src is None:
            continue
        # The new kernels' staged forms (template argument true) run at every shape.
        names = ("onehot_fetch", "shuffle_fetch") if k == "parent" else (
            "onehot_fetch_kernelILb1E", "shuffle_fetch_kernelILb1E")
        for name in names:
            for fname, ops in kernel_opcodes(src, name).items():
                res["sass"][f"{k}:{fname}"] = ops
    return res


if __name__ == "__main__":
    if "--study" in sys.argv:
        args = sys.argv[sys.argv.index("--study") + 1:]
        parent = args[args.index("--parent") + 1] if "--parent" in args else None
        print(json.dumps(study("cuda", parent)))
    else:
        main()
