"""BENCHMARK.json and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # perfbench/configs/<config>.json
    traffic: dict         # perfbench/traffic/<traffic>.json
    limits: dict          # perfbench/limits/<cell>.json
    end_to_end: list      # BENCHMARK.json entries the cell reports
    per_layer: list
    here: str             # the benchmark folder the cell's files were found in


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
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
                limits=_json(os.path.join(here, "limits", name + ".json")),
                end_to_end=e2e, per_layer=per_layer, here=here)


def scene_generator(kind: str, here: str):
    return load_module(os.path.join(here, "scenes", kind + ".py"), f"perfbench_scene_{kind}")


def sky_generator(kind: str, here: str):
    return load_module(os.path.join(here, "skies", kind + ".py"), f"perfbench_sky_{kind}")


def metric_reader(name: str, here: str) -> Any:
    """perfbench/metrics/<name>.py's `read(ctx)`: the metric's value, or
    None where the run holds nothing to read it from."""
    return load_module(os.path.join(here, "metrics", name + ".py"),
                       "perfbench_metric_" + name.replace(".", "_")).read
