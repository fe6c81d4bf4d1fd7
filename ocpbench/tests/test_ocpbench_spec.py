"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds
its files by name, including a cell added as files and entries alone."""

import json
import os
import re

import pytest

from conftest import REPO
from ocpbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["ocpbench"]
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ocpbench/") and os.path.isfile(os.path.join(REPO, c["file"]))
        names.add(c["name"])
    used = {w["config"] for w in b["workloads"]}
    assert used == names
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    every = [x["name"] for x in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in every)
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert spec.applies(e2e[m["moves"]], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in b["end_to_end"] if spec.applies(m, cell)]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(spec.applies(m, cell) for m in b["per_layer"])


def test_every_cell_resolves():
    for w in bench()["workloads"]:
        cell = spec.resolve(w["name"], REPO)
        assert callable(cell.mode.Program) and callable(cell.mode.numbers)
        assert callable(cell.reference.dynamics)
        assert cell.limits and all("limit" in v for v in cell.limits.values())
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(REPO, m["name"]))


def test_cell_added_as_files_is_found(bench_root):
    bench_root.add_cell("bryson.sweep64", "bryson-denham", "sweep64_boundary_speeds",
                        like="bryson.sweep512", batch=64)
    with open(bench_root.file("metrics/solves_per_iter.py"), "w") as f:
        f.write("def read(r):\n    return r.solved / max(r.counters['outer_iterations'], 1)\n")
    b = bench_root.bench()
    b["per_layer"].append({"name": "solves_per_iter", "unit": "solves/iter", "better": "higher",
                           "source": "program_counter", "layer": "solver (core/ipm.py)",
                           "moves": "solves_per_s", "workloads": ["bryson.sweep64"]})
    bench_root.write_bench(b)
    cell = spec.resolve("bryson.sweep64", bench_root.path)
    assert cell.traffic["batch"] == 64 and cell.traffic_name == "sweep64_boundary_speeds"
    assert "solves_per_iter" in [m["name"] for m in cell.per_layer]
    assert spec.reader(bench_root.path, "solves_per_iter") is not None
    with pytest.raises(KeyError):
        spec.resolve("bryson.sweep128", bench_root.path)

