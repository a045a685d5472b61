"""On the card: the control (the reference in the precision below the
configuration's, the cell's "control") fails the cell's comparison, and
the program passes it, at the cell's own sizes with one unit of work a
seed. Skipped without a card; on the card run

    python -m pytest -m cuda perfbench/tests/test_perfbench_cuda.py
"""

import math

import pytest
import torch

from perfbench import calibrate, harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("cell", ["deepest.estimate.bf16",
                                  "deepest.estimate.f32",
                                  "deepest.train.b32", "ldamp.train.b128"])
def test_control_fails_and_program_passes(card, cell):
    harness.set_cache_dirs()
    limits = harness.load_json("workloads", cell)["limits"]
    r = calibrate.readings(cell, 2**33 + 17, 1)

    def ok(got):
        return all(math.isfinite(got[k]) and got[k] <= v
                   for k, v in limits.items())

    assert ok(r["program"]), r["program"]
    assert not ok(r["control"]), r["control"]
    for fault in set(r) - {"cell", "seed", "program", "control",
                           "program_s", "reference_s"}:
        assert not ok(r[fault]), (fault, r[fault])
