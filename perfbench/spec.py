"""The manifest and the files it names, found by name.

Imports nothing but the standard library, so the process that prints a
run's result loads no part of the program.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# no module of these (top-level names, compared whole) may be loaded
BANNED = ("jax", "jaxlib", "flax", "byteps_tpu")


def loaded_banned() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str, here: str = HERE) -> dict:
    """``<kind>/<name>.json`` under this folder."""
    with open(os.path.join(here, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str, here: str = HERE):
    """``<kind>/<name>.py`` under this folder, loaded from its path (a
    metric's name holds dots, so it is no importable module name)."""
    path = os.path.join(here, kind, f"{name}.py")
    mod_name = "perfbench_{}_{}".format(
        kind, hashlib.sha1(path.encode()).hexdigest()[:12])
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell(name: str, rehearse: bool = False, root: str = ROOT,
         here: str = HERE) -> dict:
    """Everything a run of cell ``name`` needs: the cell, its
    configuration and traffic (with their ``rehearse`` overrides for a
    CPU rehearsal), its limits and the metrics it reports."""
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    c = configs[w["config"]]
    config = load_json("configs", c["name"], here)
    traffic = load_json("traffic", w["traffic"], here)
    if rehearse:
        config = dict(config, **config.get("rehearse", {}))
        traffic = dict(traffic, **traffic.get("rehearse", {}))
    return {"cell": w, "config": config, "traffic": traffic,
            "limits": load_json("limits", name, here),
            "end_to_end": [e for e in m["end_to_end"] if _applies(e, name)],
            "per_layer": [p for p in m["per_layer"] if _applies(p, name)],
            "run_seconds": m["run_seconds"]}


def read_metrics(per_layer: List[dict], ctx: dict,
                 here: str = HERE) -> Dict[str, dict]:
    """Each per-layer metric's reading; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for p in per_layer:
        value: Optional[float] = load_module("metrics", p["name"],
                                             here).read(ctx)
        if value is not None:
            out[p["name"]] = {"value": value, "unit": p["unit"]}
    return out
