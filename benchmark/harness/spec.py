"""Find everything a cell needs by the names in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own under ``benchmark/``:

- ``configs/<config>.json``       the configuration as it is run;
- ``traffic/<traffic>.json``      the traffic mix: sizes and the entry
                                  (``entries/<entry>.py``) that drives it;
- ``limits/<cell>.json``          the numbers that decide ``correct``,
                                  each with its limit and the readings
                                  it was set from;
- ``metrics/<metric>.py``         one per-layer metric's reader (or
                                  ``metrics/<stem>.py``, shared by the
                                  metrics ``<stem>.<suffix>``);
- ``counts/<count>.py``           one count of operations and bytes;
- ``peaks.json``                  the card's published peaks.

A later cell or metric is new files and new entries in BENCHMARK.json;
no file here names a cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import Any, Dict

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str) -> Any:
    with open(path) as fh:
        return json.load(fh)


def benchmark_json(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module, or where there is none,
    the one named by the part of ``name`` before its first dot (one
    reader for ``mfu.pjgrid`` and ``mfu.compdist``): imported as
    ``benchmark.<kind>.<name>`` where the name is an identifier, else (a
    metric's name holds dots) loaded by its path."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path) and "." in name:
        name = name.split(".", 1)[0]
        path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    if name.isidentifier():
        return importlib.import_module(f"benchmark.{kind}.{name}")
    key = f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    path = os.path.join(BENCH_DIR, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return read_json(path)


def peaks() -> Dict[str, float]:
    return read_json(os.path.join(BENCH_DIR, "peaks.json"))


def cell(name: str, bench: dict) -> dict:
    """Everything one cell runs with: its entry in ``workloads``, its
    configuration, its traffic, its limits and the metrics it reports
    (end-to-end with ``--trace 0``, per-layer with ``--trace 1``)."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    wl = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = read_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json("traffic", wl["traffic"])
    limits = load_json("limits", name)

    def reported(metrics):
        return [m for m in metrics
                if "workloads" not in m or name in m["workloads"]]

    return {"workload": wl, "config": config, "traffic": traffic,
            "limits": limits,
            "end_to_end": reported(bench["end_to_end"]),
            "per_layer": reported(bench["per_layer"])}
