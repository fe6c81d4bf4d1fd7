"""On the card, at each cell's own size: the program's run is correct, and
the control (the program's float32 path) fails the comparison. Run on a GPU
machine with ``python -m pytest ocpbench/tests -m card``."""

import json
import os

import pytest
import torch

from conftest import REPO
from ocpbench import control, judge, spec

CELLS = [w["name"] for w in json.load(open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_correct_and_control_not(card, name):
    cell = spec.resolve(name, REPO)
    program = control.readings(cell, 2 ** 31 + 101)
    assert judge.decide(cell, program["numbers"])[0], program
    ctl = control.readings(cell, 2 ** 31 + 202, dtype=torch.float32, calls=1)
    assert not judge.decide(cell, ctl["numbers"])[0], ctl
