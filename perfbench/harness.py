"""One run of one cell: find its files by name, set up, measure, trace,
check, print.

A cell `workloads/<cell>.json` names its configuration (`configs/
<config>.json`), its driver (`drivers/<driver>.py`), its traffic (the
driver's parameters), the limits of its comparison and, where its
deployment fixes one, the host's intra-op threads ("host_threads"; the
process's default without it). `BENCHMARK.json` at the checkout's root
says which end-to-end metrics the cell reports (each besides `setup_s`
is the rate of the units' work over the window) and which per-layer
metrics (`metrics/<metric>.py`) read its traced slice.

A driver module defines `Driver(config, cell, seed, device)` with:
  setup()          make the data and weights from the seed, build the
                   program's objects, warm every shape the cell uses
  unit() -> dict   one whole unit of work (a sweep, a chunk of steps);
                   returns its work: "done" (estimates or steps) and the
                   counts `work.py` reads. The traced slice is the cell's
                   "trace_units" units (1 unless its traffic says)
  release()        free the program's state once the window has closed
  check() -> list  (name, value, limit) of every number compared with
                   the reference; the run is correct when each value is
                   finite and at most its limit
  failed, attempted  answers that failed, and all answers of the window
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "score_based_channels_tpu")


def load_json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def benchmark() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def driver_module(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def metric_module(name: str):
    """metrics/<name>.py, loaded by its path (metric names hold dots)."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernel library is built under build/kernels/)."""
    cache = CHECKOUT / "build" / "perfbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def card_state() -> str:
    """The card's name, power limit, SM clock and active clock-throttle
    reasons, as nvidia-smi reads them (outside set-up and the window)."""
    import subprocess

    for reasons in ("clocks_event_reasons.active",
                    "clocks_throttle_reasons.active", None):
        fields = "name,power.limit,clocks.sm" + (f",{reasons}" if reasons
                                                 else "")
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--query-gpu={fields}",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20)
        except (OSError, subprocess.SubprocessError):
            return "not read"
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return "not read"


def merged(works: list) -> dict:
    """The work of several units as one: counts added, the rest kept."""
    out = dict(works[0])
    for w in works[1:]:
        out["done"] += w["done"]
        for k, v in w.items():
            if isinstance(v, dict):
                acc = dict(out[k])
                for b, n in v.items():
                    acc[b] = acc.get(b, 0) + n
                out[k] = acc
    return out


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float) -> int:
    set_cache_dirs()
    import torch

    bench = benchmark()
    cell = load_json("workloads", cell_name)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if "host_threads" in cell:
        torch.set_num_threads(int(cell["host_threads"]))
    config = load_json("configs", cell["config"])
    drv = driver_module(cell["driver"]).Driver(config, cell, seed, "cuda")

    t_drv = time.perf_counter()
    drv.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    own = time.perf_counter() - t_drv
    print(f"# setup {setup_s:.3f} s (the driver's {own:.3f} s); "
          f"{torch.get_num_threads()} host threads; card {card_state()}",
          file=sys.stderr, flush=True)

    done, ends = 0, []
    t0 = time.perf_counter()
    while True:  # the window: whole units, the last one crossing the end
        done += drv.unit()["done"]
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    elapsed = ends[-1]
    rate = done / elapsed
    q = statistics.quantiles([b - a for a, b in zip([0.0] + ends, ends)],
                             n=4) if len(ends) > 1 else [elapsed] * 3
    print(f"# window {elapsed:.3f} s, {len(ends)} units, {done} done; "
          f"unit s quartiles {q[0]:.4f} {q[1]:.4f} {q[2]:.4f}; card "
          f"{card_state()}", file=sys.stderr, flush=True)

    device = device_info(torch, chips)
    metrics, breakdown = {}, None
    if trace:
        from . import trace as tr

        n = int(cell["traffic"].get("trace_units", 1))
        sl = tr.traced(lambda: merged([drv.unit() for _ in range(n)]))
        device["busy_s"] = sl.busy_s()
        device["window_s"] = sl.wall_s
        for m in cell_metrics(bench, cell_name, "per_layer"):
            v = metric_module(m["name"]).read(sl)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": sl.top_ops(10),
                     "idle_gaps": sl.idle_gaps(10)}
        print(f"# traced slice {sl.wall_s:.3f} s, busy {sl.busy_s():.3f} s, "
              f"{len(sl.device_ops)} device ops", file=sys.stderr, flush=True)
    else:
        for m in cell_metrics(bench, cell_name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else rate
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(f"# memory peak {device['memory_peak_bytes']} bytes",
          file=sys.stderr, flush=True)

    drv.release()
    t_check = time.perf_counter()
    checks = drv.check()
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    print(f"# check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr, flush=True)

    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the process loaded {bad}", file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"{name} {v!r} limit {lim!r}", file=sys.stderr)
    line = {"correct": correct, "attempted": drv.attempted,
            "failed": drv.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
