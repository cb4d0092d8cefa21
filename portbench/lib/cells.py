"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``traffic/<mix>.json``.  Its
checks for ``correct`` and their limits are ``limits/<cell>.json``, each
check read by ``checks/<check>.py``, and each metric by
``metrics/<metric>.py``; a metric with a ``workloads`` key is reported in
those cells alone.  A new configuration, mix, cell or metric is a
new file and a new entry: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

#: the benchmark's folder and the repository root above it
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclass(frozen=True)
class Cell:
    root: str             # the checkout that holds BENCHMARK.json
    bench: str            # the benchmark's folder, relative to root
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list      # metric entries of BENCHMARK.json
    per_layer: list


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reported(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(cell: str, root: str = ROOT) -> Cell:
    """The cell named ``cell`` of ``root``'s BENCHMARK.json."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    (work,) = [w for w in spec["workloads"] if w["name"] == cell] or [None]
    if work is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    (conf,) = [c for c in spec["configs"] if c["name"] == work["config"]]
    bench = os.path.join(root, spec["paths"][0])
    return Cell(
        root=root, bench=spec["paths"][0], name=cell, chips=work["chips"],
        config=_json(os.path.join(root, conf["file"])),
        mix=_json(os.path.join(bench, "traffic", f"{work['traffic']}.json")),
        limits=_json(os.path.join(bench, "limits", f"{cell}.json")),
        end_to_end=[m for m in spec["end_to_end"] if _reported(m, cell)],
        per_layer=[m for m in spec["per_layer"] if _reported(m, cell)])


def reader(name: str, root: str):
    """``read(record) -> float | None`` of ``metrics/<name>.py`` in the
    benchmark's folder under ``root``."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    path = os.path.join(root, spec["paths"][0], "metrics", f"{name}.py")
    module_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read
