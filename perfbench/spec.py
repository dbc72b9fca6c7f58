"""BENCHMARK.json and the files it names, found by name."""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import os
import sys
from typing import Any, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEFAULT_REFERENCE = "reference"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # perfbench/configs/<config>.json
    traffic: dict         # perfbench/traffic/<traffic>.json
    limits: dict          # perfbench/limits/<cell>.json
    end_to_end: list      # BENCHMARK.json entries the cell reports
    per_layer: list
    here: str             # the benchmark folder the cell's files were found in
    reference: str        # the configuration's reference package under `here`


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    here = os.path.join(root, "perfbench")
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    reference = config.get("reference", DEFAULT_REFERENCE)
    if reference not in (DEFAULT_REFERENCE, f"{DEFAULT_REFERENCE}_{w['config']}"):
        raise ValueError(f"configuration {w['config']!r} names the reference {reference!r}: "
                         f"a configuration's reference is {DEFAULT_REFERENCE!r} or "
                         f"'{DEFAULT_REFERENCE}_{w['config']}'")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
                limits=_json(os.path.join(here, "limits", name + ".json")),
                end_to_end=e2e, per_layer=per_layer, here=here, reference=reference)


def scene_generator(kind: str, here: str):
    return load_module(os.path.join(here, "scenes", kind + ".py"), f"perfbench_scene_{kind}")


def sky_generator(kind: str, here: str):
    return load_module(os.path.join(here, "skies", kind + ".py"), f"perfbench_sky_{kind}")


def reference(name: str, here: str):
    """The `render` module of the reference package <here>/<name>, which
    the harness calls through `settings(pt)` (the configuration's whole
    `pt` dict, as the program's PathTracerSettings gets it),
    `build_scene(scene, sky, device, control=False)`, `accumulate(ref,
    settings, c2w, resolution, px, py, seeds)` and `frame_u8(acc, px, py,
    frame_index)`. A package's modules import each other relatively, so a
    copy under another name calls its own."""
    path = os.path.join(here, name)
    if not all(os.path.isfile(os.path.join(path, f)) for f in ("__init__.py", "render.py")):
        raise FileNotFoundError(f"no reference package {path} (__init__.py and render.py)")
    if os.path.samefile(here, HERE):
        return importlib.import_module(f"perfbench.{name}.render")
    # A benchmark folder other than this one (a copy of a checkout): its
    # package under a name of its own path.
    pkg = "perfbench_reference_" + hashlib.sha256(path.encode()).hexdigest()[:16]
    if pkg not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            pkg, os.path.join(path, "__init__.py"), submodule_search_locations=[path])
        sys.modules[pkg] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[pkg])
    return importlib.import_module(pkg + ".render")


def metric_reader(name: str, here: str) -> Any:
    """perfbench/metrics/<name>.py's `read(ctx)`: the metric's value, or
    None where the run holds nothing to read it from.

    ctx, in a traced run: frames (drawn in the window), frame_s (window
    seconds a frame), and for each window frame, in order, frame_ms,
    pass_ms (the program's span ms, `Renderer.stats["pass_ms"]`) and counts
    (its counters, a copy of `Renderer.stats["counts"]`: k1_launches,
    alpha_hops, alpha_reads, chunks); over the window, k1_launches and
    alpha_hops (the module counters' deltas); k1_calls, k1_bytes and
    k1_mean_s (the K1 recorder, perfbench/trace.py); kind (the device's
    name); profiled_frames and device (busy_s, window_s of the frames
    under torch.profiler after the window)."""
    return load_module(os.path.join(here, "metrics", name + ".py"),
                       "perfbench_metric_" + name.replace(".", "_")).read
