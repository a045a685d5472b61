"""utils/trace_analysis.py of the PyTorch port: the device-time tables of
a torch.profiler chrome trace, on synthetic traces with known kernel,
copy and set events (and host events it must leave out), and on a real
CPU trace, which holds no device event.
"""

import gzip
import io
import json
import os

import pytest
import torch

from score_based_channels_torch.utils import trace_analysis as ta

EVENTS = [
    # name, cat, dur us, args
    ("conv2d_taps_wgmma<128>", "kernel", 100.0, {"grid": [132, 1, 1]}),
    ("conv2d_taps_wgmma<128>", "kernel", 60.0, {}),
    ("instance_norm_plus_kernel", "kernel", 30.0, {}),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 8.0,
     {"bytes": 8_000_000}),
    ("Memset (Device)", "gpu_memset", 2.0, {}),
]
HOST = [("aten::conv2d", "cpu_op", 500.0, {"flops": 10 ** 9}),
        ("cudaLaunchKernel", "cuda_runtime", 5.0, {}),
        ("ProfilerStep#1", "user_annotation", 900.0, {})]


def _trace(events):
    out, t = [], 0.0
    for name, cat, dur, args in events:
        out.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                    "ts": t, "dur": dur, "args": args})
        t += dur
    out.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": t})
    return {"schemaVersion": 1, "traceEvents": out}


@pytest.fixture(params=["json", "gz", "dir"])
def trace_path(request, tmp_path):
    tr = _trace(EVENTS + HOST)
    if request.param == "gz":
        p = tmp_path / "w.pt.trace.json.gz"
        with gzip.open(p, "wt") as f:
            json.dump(tr, f)
        return str(p)
    p = tmp_path / "sub" / "host_1.pt.trace.json"
    p.parent.mkdir()
    p.write_text(json.dumps(tr))
    if request.param == "dir":
        old = tmp_path / "sub" / "old.pt.trace.json"
        old.write_text(json.dumps(_trace(EVENTS[:1])))
        os.utime(old, (0, 0))  # older than the other: not picked
        return str(tmp_path)
    return str(p)


def test_summary_adds_up_the_device_events(trace_path):
    buf = io.StringIO()
    s = ta.summarize(trace_path, top=3, out=buf)
    assert s["events"] == 5
    assert s["total_ms"] == pytest.approx(0.2)
    cats = s["by_category"]
    assert set(cats) == {"kernel", "gpu_memcpy", "gpu_memset"}
    assert cats["kernel"]["ms"] == pytest.approx(0.19)
    assert cats["kernel"]["count"] == 3
    assert cats["kernel"]["share"] == pytest.approx(0.95)
    assert cats["kernel"]["mean_us"] == pytest.approx(190 / 3)
    conv = s["by_name"]["conv2d_taps_wgmma<128>"]
    assert (conv["count"], conv["mean_us"]) == (2, pytest.approx(80.0))
    assert conv["share"] == pytest.approx(0.8)
    # a rate only where the event carries its bytes: 8 MB in 8 us = 1 TB/s
    assert cats["gpu_memcpy"]["gbps"] == pytest.approx(1000.0)
    assert cats["kernel"]["gbps"] is None and conv["tflops"] is None
    assert all(r["tflops"] is None for r in cats.values())
    text = buf.getvalue()
    assert "total device time: 0.200 ms (5 events)" in text
    assert "aten::conv2d" not in text and "cudaLaunchKernel" not in text
    top = text.split("== top 3 by total time ==")[1].strip().splitlines()
    assert len(top) == 3 and "conv2d_taps" in top[0]
    assert "instance_norm_plus" in top[1]
    assert "29.9" in top[2]  # the copy's share of the H100 peak, %


def test_top_lines_and_the_peaks():
    assert ta.H100_PEAK_GBPS == 3350.0 and ta.H100_PEAK_TFLOPS_BF16 == 989.0


def test_cli_prints_the_tables(trace_path, capsys):
    ta.main([trace_path, "--top", "2", "--peak-gbps", "2000"])
    out = capsys.readouterr().out
    assert "== by category ==" in out and "== top 2 by total time ==" in out
    assert "50.0%" in out  # 1,000 GB/s of a 2,000 GB/s peak


def test_a_cpu_profile_has_no_device_events(tmp_path, capsys):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    path = str(tmp_path / "cpu.pt.trace.json")
    prof.export_chrome_trace(path)
    s = ta.summarize(str(tmp_path))
    assert s["events"] == 0 and s["total_ms"] == 0.0
    assert "no device events found" in capsys.readouterr().out


def test_a_directory_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ta.summarize(str(tmp_path))
