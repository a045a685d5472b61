"""The harness finds every piece by its name, and a new piece is a new
file and a new entry, with no edit to a file that is there."""

import json
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_entry_has_its_files():
    b = harness.benchmark()
    for c in b["configs"]:
        assert (harness.CHECKOUT / c["file"]).is_file()
        assert harness.load_json("configs", c["name"])["name"] == c["name"]
    for w in b["workloads"]:
        cell = harness.load_json("workloads", w["traffic"])
        assert w["traffic"] == w["name"]
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert hasattr(harness.driver_module(cell["driver"]), "Driver")
        reported = [m["name"] for m in harness.cell_metrics(
            b, w["name"], "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert "metric" not in cell
        assert harness.cell_metrics(b, w["name"], "per_layer")
    for m in b["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)


def test_contract_shapes():
    b = harness.benchmark()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert 1 <= b["run_seconds"] <= 51
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(b)) < 64 * 1024


@pytest.fixture
def copy_root(tmp_path, monkeypatch):
    """The benchmark's data files in a copy, the harness pointed at it."""
    root = tmp_path / "perfbench"
    for d in ("configs", "workloads", "metrics", "shapes"):
        shutil.copytree(harness.ROOT / d, root / d)
    shutil.copy(harness.CHECKOUT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "CHECKOUT", tmp_path)
    return root


def test_new_files_need_no_edit(copy_root):
    """A new cell (a traffic file for an existing driver) and a new metric
    (a reader file) are found by name once BENCHMARK.json lists them."""
    before = {p: p.read_bytes() for p in copy_root.rglob("*") if p.is_file()}
    cell = harness.load_json("workloads", "deepest.estimate.bf16")
    cell["traffic"]["chunk"] = 64
    (copy_root / "workloads" / "deepest.estimate.chunk64.json").write_text(
        json.dumps(cell))
    (copy_root / "metrics" / "launches.estimate.py").write_text(
        "def read(sl):\n    return float(len(sl.device_ops)) or None\n")
    b = json.loads((copy_root.parent / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(b["workloads"][0],
                               name="deepest.estimate.chunk64",
                               traffic="deepest.estimate.chunk64"))
    b["end_to_end"][0]["workloads"].append("deepest.estimate.chunk64")
    b["per_layer"].append({"name": "launches.estimate", "unit": "launches",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "estimates_per_s",
                           "workloads": ["deepest.estimate.chunk64"]})
    (copy_root.parent / "BENCHMARK.json").write_text(json.dumps(b))
    for p, data in before.items():
        assert p.read_bytes() == data
    b = harness.benchmark()
    got = harness.load_json("workloads", "deepest.estimate.chunk64")
    assert got["traffic"]["chunk"] == 64
    assert harness.driver_module(got["driver"]).Driver
    per = [m["name"] for m in harness.cell_metrics(
        b, "deepest.estimate.chunk64", "per_layer")]
    assert "launches.estimate" in per
    assert "launches.estimate" not in [m["name"] for m in harness.cell_metrics(
        b, "deepest.estimate.bf16", "per_layer")]
    assert harness.metric_module("launches.estimate").read(
        type("S", (), {"device_ops": [1, 2]})()) == 2.0


def test_run_without_a_card_prints_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.run("deepest.estimate.bf16", 1, 1.0, False, 0.0) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "score_based_channels_tpu_x",
                        types.ModuleType("x"))
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.loaded_forbidden() == ["jax"]
