"""The control at a size a test run holds: the plain reference computed
with FP8 products (the nearest precision below the configurations'
bfloat16) put in the program's place must fail at least one of its
cell's limits, on several seeds.  The chip readings at each cell's own
size, which the limits are set from, are ``gpubench/calibrate.py``'s."""
from __future__ import annotations

import pytest

from gpubench import calibrate, harness, tiny

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 99])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_its_cell(cell, seed):
    config, traffic = tiny.cell(cell)
    limits = harness.resolve(harness.benchmark(), cell)[3]["limits"]
    numbers = calibrate.readings(cell, seed, "control", device="cpu",
                                 config=config, traffic=traffic)
    assert set(limits) <= set(numbers)
    assert any(numbers[k] > limits[k] for k in limits), numbers
