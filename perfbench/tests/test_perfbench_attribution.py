"""`attribution.py` and the `device_idle_pct.<group>.*` readers on
synthetic slices and span lists: the card's idle time split by time among
the innermost program spans, the parts under none unattributed."""

import collections
import re
import sys

import pytest

from perfbench import attribution, harness
from perfbench.trace import Slice
from score_based_channels_torch.utils import spans

S = spans.Span
US = 1000  # ns
GROUPS = ("capture", "host_prep", "launch", "readback", "unattributed")
NEW = {"estimate": GROUPS, "train": ("host_prep", "launch", "unattributed")}


def _slice(ops, t0=0, t1=100 * US):
    return Slice((t1 - t0) / 1e9, [("k", s * US, e * US) for s, e in ops],
                 [], {}, t0, t1)


def _ring(monkeypatch, records):
    """The program's ring holding these (name, start us, end us, parent)
    records, indices in order."""
    ring = collections.deque(maxlen=spans.CAPACITY)
    for i, (name, s, e, parent) in enumerate(records):
        ring.append(S(name, s * US, e * US, parent, i))
    monkeypatch.setattr(spans, "_ring", ring)


def _read(name, sl):
    return harness.metric_module(name).read(sl)


def test_groups_sum_to_the_idle_share(monkeypatch):
    _ring(monkeypatch, [("sweep.draws", 0, 12, None),
                        ("sweep.pad", 14, 18, None),
                        ("sampler.run", 18, 70, None),
                        ("sampler.load", 18, 22, 2),
                        ("graph.warm_up", 22, 30, 2),
                        ("graph.capture", 30, 40, 2),
                        ("sampler.level", 40, 41, 2),
                        ("sweep.readback", 75, 95, None)])
    sl = _slice([(5, 10), (25, 28), (45, 80), (90, 92)])
    total = _read("device_idle_pct.estimate", sl)
    got = {g: _read(f"device_idle_pct.{g}.estimate", sl) for g in GROUPS}
    assert sum(got.values()) == pytest.approx(total)
    assert total == pytest.approx(100 - 5 - 3 - 35 - 2)
    # idle 0-5 and 10-12 draws, 12-14 none, 14-18 pad, 18-22 load; 22-25,
    # 28-30 warm-up and 30-40 capture; 40-41 level, 41-45 run; 80-90,
    # 92-95 read-back, 95-100 none
    assert got == pytest.approx({"host_prep": 7 + 4 + 4, "capture": 15,
                                 "launch": 5, "readback": 13,
                                 "unattributed": 2 + 5})
    for g in NEW["train"]:  # the training files read as the estimate's
        assert _read(f"device_idle_pct.{g}.train", sl) == got[g]


def test_a_gap_across_nested_and_sibling_spans_splits_by_time(monkeypatch):
    """One idle gap (10-90) over a run (launch) holding a load
    (host_prep), a level (launch) holding a capture, and a batch beside
    them: each part goes to the innermost span open, not the gap's
    middle."""
    _ring(monkeypatch, [("ldamp.run", 5, 80, None),
                        ("ldamp.load", 12, 20, 0),
                        ("ldamp.step", 20, 60, 0),
                        ("graph.capture", 30, 35, 2),
                        ("data.sample_batch", 60, 75, 0),
                        ("sweep.readback", 85, 95, None)])
    sl = _slice([(0, 10), (90, 100)])
    got = attribution.idle_seconds(sl)
    want = {"launch": (12 - 10) + (30 - 20) + (60 - 35) + (80 - 75),
            "host_prep": (20 - 12) + (75 - 60), "capture": 5,
            "readback": 90 - 85, "unattributed": 85 - 80}
    assert got == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(80e-6)


def test_gaps_at_the_slice_edges(monkeypatch):
    """Idle time before the first and after the last device operation
    counts, clipped to the slice; spans reaching outside it are clipped
    too; operations outside the slice are not idle time."""
    _ring(monkeypatch, [("sweep.draws", 0, 30, None),
                        ("sweep.readback", 70, 120, None)])
    sl = _slice([(-20, 25), (40, 60), (110, 130)], t0=10 * US, t1=100 * US)
    got = attribution.idle_seconds(sl)
    assert got["host_prep"] == pytest.approx(5e-6)      # 25-30
    assert got["readback"] == pytest.approx(30e-6)      # 70-100
    assert got["unattributed"] == pytest.approx(20e-6)  # 30-40, 60-70
    assert attribution.idle_intervals(sl) == [(25 * US, 40 * US),
                                              (60 * US, 100 * US)]
    sl = _slice([(30, 40)])  # nothing at either edge
    _ring(monkeypatch, [])
    assert attribution.idle_intervals(sl) == [(0, 30 * US),
                                              (40 * US, 100 * US)]


def test_no_program_spans_is_all_unattributed(monkeypatch):
    _ring(monkeypatch, [])
    sl = _slice([(10, 20), (50, 60)])
    got = {g: _read(f"device_idle_pct.{g}.estimate", sl) for g in GROUPS}
    assert got["unattributed"] == pytest.approx(80.0)
    assert all(got[g] == 0.0 for g in GROUPS[:-1])
    assert all(isinstance(v, float) for v in got.values())


def test_an_unlisted_span_gives_its_time_to_the_listed_one_around(
        monkeypatch):
    _ring(monkeypatch, [("sampler.run", 0, 100, None),
                        ("sampler.something_new", 20, 60, 0),
                        ("sampler.load", 40, 50, 1)])
    got = attribution.idle_seconds(_slice([(90, 100)]))
    assert got["launch"] == pytest.approx(80e-6)
    assert got["host_prep"] == pytest.approx(10e-6)


def test_a_program_without_spans_gives_no_reading(monkeypatch):
    monkeypatch.setitem(sys.modules, "score_based_channels_torch.utils.spans",
                        None)
    monkeypatch.delattr(sys.modules["score_based_channels_torch.utils"],
                        "spans")
    sl = _slice([(10, 20)])
    for kind, groups in NEW.items():
        for g in groups:
            assert _read(f"device_idle_pct.{g}.{kind}", sl) is None


def test_an_empty_slice_gives_no_reading(monkeypatch):
    _ring(monkeypatch, [("sampler.run", 0, 100, None)])
    assert attribution.idle_pct(_slice([]), "launch") is None


def test_every_new_metric_is_listed_with_its_cells():
    b = harness.benchmark()
    per = {m["name"]: m for m in b["per_layer"]}
    cells = {"estimate": ["deepest.estimate.bf16", "deepest.estimate.f32"],
             "train": ["ldamp.train.b128", "deepest.train.b32"]}
    moves = {"estimate": "estimates_per_s", "train": "train_steps_per_s"}
    for kind, groups in NEW.items():
        for g in groups:
            m = per[f"device_idle_pct.{g}.{kind}"]
            assert m["workloads"] == cells[kind]
            assert (m["unit"], m["better"], m["source"], m["moves"]) == (
                "%", "lower", "device_trace", moves[kind])
            assert callable(harness.metric_module(m["name"]).read)


def test_every_span_of_the_port_has_a_group():
    names = set()
    root = harness.CHECKOUT / "score_based_channels_torch"
    for path in root.rglob("*.py"):
        names |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert names == set(attribution.GROUPS)
    assert set(attribution.GROUPS.values()) == set(GROUPS[:-1])
