"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each lives in files of its
own, so a later cell, configuration, traffic mix or per-layer metric is
added as files and entries, with no edit to a file that is here:

- the configuration: the ``file`` that ``BENCHMARK.json`` gives it, and its
  plain reference ``ocpbench/reference/<config>.py``;
- the traffic mix: ``ocpbench/traffic/<traffic>.json``, and the mode it
  names: ``ocpbench/modes/<mode>.py`` (how a call drives the program and
  how its answers are judged; see ``program.py``);
- the cell's correctness limits: ``ocpbench/limits/<cell>.json``;
- a per-layer metric: its reader ``ocpbench/metrics/<metric>.py``, a
  function ``read(readings)`` that returns a number or ``None``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOME = "ocpbench"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    reference: object
    mode: object
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: str = ROOT


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """The Python file at ``path`` as a module of its own (names such as
    ``hypersensitive-tf5000`` or ``ipm_iter_ms.sweep`` are not importable)."""
    name = "ocpbench_file_" + re.sub(r"\W", "_", os.path.relpath(path, ROOT))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its files read."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = configs[w["config"]]
    here = os.path.join(root, HOME)
    traffic = load_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=cfg["name"], config=load_json(os.path.join(root, cfg["file"])),
        traffic_name=w["traffic"],
        traffic=traffic,
        limits=load_json(os.path.join(here, "limits", f"{name}.json")),
        reference=load_module(os.path.join(here, "reference", f"{cfg['name']}.py")),
        mode=load_module(os.path.join(here, "modes", f"{traffic['mode']}.py")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        root=root,
    )


def reader(root: str, metric: str):
    """The ``read`` function of the per-layer metric ``metric``."""
    return load_module(os.path.join(root, HOME, "metrics", f"{metric}.py")).read
