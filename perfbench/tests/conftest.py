"""Shared fixtures of the benchmark's tests: the tiny CPU versions of the
cells (the cells' own drivers and limits, at sizes a CPU test holds)."""

import copy

import pytest

from perfbench import harness


def tiny(cell_name: str):
    """(config, cell) of a cell cut to a CPU test's size: the same driver,
    traffic keys and limits, fewer rows, levels, steps and unrolls."""
    cell = copy.deepcopy(harness.load_json("workloads", cell_name))
    config = copy.deepcopy(harness.load_json("configs", cell["config"]))
    t = cell["traffic"]
    if cell["driver"] == "estimate":
        t.update(channels=2, snr_db=[0.0, 20.0], chunk=4, stride=770,
                 warm_stride=2310, check_rows=4)
    elif cell["driver"] == "train_score":
        config["training"].update(batch_size=4, log_every_steps=2)
        config["data"]["train_channels"] = 16
    else:
        config["training"].update(batch_size=9, decay_epochs=3)
        config["data"]["train_channels"] = 16
        config["model"]["unrolls"] = 2
    return config, cell


@pytest.fixture
def tiny_cell():
    return tiny
