"""Fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary directory, to which a test adds cells as files and entries alone.
The copy also holds the cell ``bryson.sweep512``, whose files the benchmark
keeps while ``BENCHMARK.json`` leaves it out (on a shared host its solves/s
spread too widely for a bound of 25 %): the copy enters it again by entries
alone, as a later change would.

Tests marked ``card`` need a CUDA device; the ``card`` fixture decides,
when the test runs, whether there is one."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on a GPU machine: "
                    "python -m pytest ocpbench/tests -m card")
    return torch.device("cuda")


# the entries of the cell that BENCHMARK.json leaves out, and the metrics it reports
BRYSON_CONFIG = {
    "name": "bryson-denham",
    "source": "https://github.com/eddyxzc/lpopc (Lpopc/example/bryson-denham; "
              "Bryson, Denham and Dreyfus 1963, J* = 4)",
    "file": "ocpbench/configs/bryson-denham.json", "reduced": [],
    "why": "a lockstep sweep of a small problem with a state bound, host-issued IPM "
           "iterations, K1 and K2 in their shared variants"}
BRYSON_CELL = {
    "name": "bryson.sweep512", "config": "bryson-denham", "traffic": "sweep512_boundary_speeds",
    "chips": 1,
    "why": "512 boundary speeds a sweep, mesh (6, 6), n = 53, x1 <= 1/9 active; batched IPM "
           "iterations issued from the host, K1/K2 shared; no refinement"}
BRYSON_METRICS = ("solves_per_s", "ipm_iter_ms.sweep", "host_syncs_per_iter.sweep",
                  "lane_cholesky_roofline", "lane_cho_solve_roofline", "device_idle_pct.sweep")


class BenchRoot:
    """A copy of ``BENCHMARK.json`` and ``ocpbench/`` (without its tests)."""

    def __init__(self, path):
        self.path = str(path)
        shutil.copy(os.path.join(REPO, "BENCHMARK.json"), self.path)
        shutil.copytree(os.path.join(REPO, "ocpbench"), os.path.join(self.path, "ocpbench"),
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        self.enter_bryson()

    def enter_bryson(self):
        """Enter the left-out cell ``bryson.sweep512`` and its configuration."""
        bench = self.bench()
        bench["configs"].append(dict(BRYSON_CONFIG))
        bench["workloads"].append(dict(BRYSON_CELL))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in BRYSON_METRICS:
                m["workloads"].append(BRYSON_CELL["name"])
        self.write_bench(bench)

    def file(self, rel: str) -> str:
        return os.path.join(self.path, "ocpbench", rel)

    def bench(self) -> dict:
        with open(os.path.join(self.path, "BENCHMARK.json")) as f:
            return json.load(f)

    def write_bench(self, bench: dict):
        with open(os.path.join(self.path, "BENCHMARK.json"), "w") as f:
            json.dump(bench, f, indent=1)

    def write_json(self, rel: str, data: dict):
        with open(self.file(rel), "w") as f:
            json.dump(data, f, indent=1)

    def read_json(self, rel: str) -> dict:
        with open(self.file(rel)) as f:
            return json.load(f)

    def add_cell(self, name: str, config: str, traffic: str, like: str, **traffic_changes):
        """A cell of ``config`` under a new traffic mix ``traffic`` (the mix of
        cell ``like`` with ``traffic_changes``) and ``like``'s limits, added as
        files and entries; every metric of ``like`` also lists it."""
        bench = self.bench()
        src = next(w for w in bench["workloads"] if w["name"] == like)
        mix = {**self.read_json(f"traffic/{src['traffic']}.json"), **traffic_changes}
        self.write_json(f"traffic/{traffic}.json", mix)
        shutil.copy(self.file(f"limits/{like}.json"), self.file(f"limits/{name}.json"))
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a test's cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
        self.write_bench(bench)

    def add_config(self, name: str, like: str, reference_source: str, **changes):
        """A configuration ``name``: ``like``'s file with ``changes``, and its
        reference file ``reference_source``."""
        bench = self.bench()
        src = next(c for c in bench["configs"] if c["name"] == like)
        cfg = {**self.read_json(os.path.relpath(os.path.join(self.path, src["file"]),
                                                os.path.join(self.path, "ocpbench"))),
               **changes, "name": name}
        self.write_json(f"configs/{name}.json", cfg)
        with open(self.file(f"reference/{name}.py"), "w") as f:
            f.write(reference_source)
        bench["configs"].append({**src, "name": name, "file": f"ocpbench/configs/{name}.json"})
        self.write_bench(bench)


@pytest.fixture
def bench_root(tmp_path):
    return BenchRoot(tmp_path)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
