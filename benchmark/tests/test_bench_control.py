"""The control of the output check: the plain reference computed in float8
in the program's place has to come out as not correct, at the tiny size on
the CPU and, on the card, at each training cell's own size."""

import os

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_reference import DIRS, SPEC


def _fails(checks):
    return any(c["limit"] is not None and c["value"] > c["limit"] for c in checks.values())


def test_float8_control_fails_at_the_tiny_size():
    spec = harness.load_json(SPEC)
    cell, driver, _ = harness.load_cell(spec, SPEC, DIRS, "tiny3d_train", 21, 0, False,
                                        require_card=False)
    checks = driver.follow_control(cell)
    assert _fails(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ldm3d_train", "ldm2d_train"])
def test_float8_control_fails_at_the_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    spec = harness.load_json(path)
    cell, driver, _ = harness.load_cell(spec, path, [harness.BENCH_DIR], workload, 2 ** 40 + 9,
                                        0, False)
    checks = driver.follow_control(cell)
    assert _fails(checks), checks
