"""Device-time attribution of a torch.profiler chrome trace, the
counterpart of the JAX package's utils/trace_analysis.py (which reads
its profiler's trace of XLA ops).

Adds up the device-side events of an exported trace (`cat` kernel,
gpu_memcpy and gpu_memset) by category and by name: total ms, share of
the device time, count and mean us. A rate is given only where the
event's args carry its bytes or FLOPs (a copy's "bytes"): a torch trace
has neither for a custom kernel, where XLA's has `bytes_accessed` and
`model_flops`, so those cells stay empty rather than invented. The
port's kernels have their bounds in chip_smoke.py instead.

Then the device's idle time by the program span that held it
(`idle_by_span`): the port's spans (`utils/spans.py`, the "sbc:" user
annotations of a trace taken while they ran) say which host work was
under way while no device event ran.

Usage:
  python -m score_based_channels_torch.utils.trace_analysis \\
      <trace.json[.gz] or a directory> [--peak-gbps 3350] \\
      [--peak-tflops 989] [--top 25]

A directory is searched (recursively) for its newest *.pt.trace.json or
*.pt.trace.json.gz, the names torch.profiler.tensorboard_trace_handler
writes; `prof.export_chrome_trace(path)` writes any other name.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import heapq
import json
import os
import sys
from typing import Dict, Iterator, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "sbc:"  # the port's program spans (utils/spans.py)
# datasheet peaks of the NVIDIA H100 80GB HBM3 (SXM) at 700 W
H100_PEAK_GBPS = 3350.0
H100_PEAK_TFLOPS_BF16 = 989.0


def _find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = [h for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
            for h in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not hits:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {path}")
    return max(hits, key=os.path.getmtime)


def _complete_events(path: str) -> List[Dict]:
    """The complete ("ph": "X") events of the trace."""
    trace = _find_trace(path)
    opener = gzip.open if trace.endswith(".gz") else open
    with opener(trace, "rt") as f:
        tr = json.load(f)
    events = tr.get("traceEvents", []) if isinstance(tr, dict) else tr
    return [e for e in events if e.get("ph") == "X"]


def load_device_events(path: str) -> Iterator[
        Tuple[str, str, float, Optional[int], Optional[int]]]:
    """Yield (name, category, dur_us, bytes or None, flops or None) of each
    complete device event of the trace."""
    for e in _complete_events(path):
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        args = e.get("args") or {}
        nbytes, flops = args.get("bytes"), args.get("flops")
        yield (e.get("name", "?"), e["cat"], float(e.get("dur", 0.0)),
               None if nbytes is None else int(nbytes),
               None if flops is None else int(flops))


def _row(t_us: float, n: int, nbytes: Optional[int], flops: Optional[int],
         total_us: float) -> Dict:
    # bytes / us = MB/s, / 1e3 -> GB/s; flops / us / 1e6 -> TFLOP/s
    return dict(ms=t_us / 1e3, share=t_us / total_us if total_us else 0.0,
                count=n, mean_us=t_us / n if n else 0.0,
                gbps=nbytes / t_us / 1e3 if nbytes and t_us else None,
                tflops=flops / t_us / 1e6 if flops and t_us else None)


def _cell(v: Optional[float], peak: float, width: int) -> str:
    if v is None:
        return " " * width + " " * 8
    return f"{v:{width}.1f} {100 * v / peak:7.1f}%"


def summarize(path: str, peak_gbps: float = H100_PEAK_GBPS,
              peak_tflops: float = H100_PEAK_TFLOPS_BF16, top: int = 25,
              out=None) -> Dict:
    """Print the by-category and top-by-name tables; return them as
    {"total_ms", "events", "by_category", "by_name"}, each table
    {key: {ms, share, count, mean_us, gbps, tflops}} (rates None where the
    trace carries no bytes or FLOPs). out: a text stream (stdout)."""
    out = out or sys.stdout
    acc = {"cat": collections.defaultdict(lambda: [0.0, 0, None, None]),
           "name": collections.defaultdict(lambda: [0.0, 0, None, None])}
    total_us, n_events = 0.0, 0
    for name, cat, dur, nbytes, flops in load_device_events(path):
        total_us += dur
        n_events += 1
        for table, key in (("cat", cat), ("name", name)):
            r = acc[table][key]
            r[0] += dur
            r[1] += 1
            if nbytes is not None:
                r[2] = (r[2] or 0) + nbytes
            if flops is not None:
                r[3] = (r[3] or 0) + flops
    summary = {"total_ms": total_us / 1e3, "events": n_events,
               "by_category": {k: _row(*v, total_us)
                               for k, v in acc["cat"].items()},
               "by_name": {k: _row(*v, total_us)
                           for k, v in acc["name"].items()}}
    if not n_events:
        print("no device events found", file=out)
        return summary

    print(f"total device time: {total_us / 1e3:.3f} ms ({n_events} events)",
          file=out)
    print("\n== by category ==", file=out)
    print(f"{'category':14s} {'time%':>6s} {'time ms':>9s} {'count':>7s} "
          f"{'mean us':>9s} {'GB/s':>7s} {'%peak':>8s} {'TFLOP/s':>7s} "
          f"{'%peak':>8s}", file=out)
    for cat, r in sorted(summary["by_category"].items(),
                         key=lambda kv: -kv[1]["ms"]):
        print(f"{cat:14s} {100 * r['share']:6.1f} {r['ms']:9.3f} "
              f"{r['count']:7d} {r['mean_us']:9.2f} "
              f"{_cell(r['gbps'], peak_gbps, 7)} "
              f"{_cell(r['tflops'], peak_tflops, 7)}", file=out)
    print(f"\n== top {top} by total time ==", file=out)
    for line in top_lines(summary, top, peak_gbps, peak_tflops):
        print(line, file=out)
    return summary


def top_lines(summary: Dict, top: int = 5,
              peak_gbps: float = H100_PEAK_GBPS,
              peak_tflops: float = H100_PEAK_TFLOPS_BF16):
    """The `top` names by total device time, one formatted line each."""
    rows = sorted(summary["by_name"].items(), key=lambda kv: -kv[1]["ms"])
    return [f"{100 * r['share']:5.1f}%  {r['ms']:9.3f} ms  n={r['count']:<6d} "
            f"mean={r['mean_us']:8.2f} us  "
            f"{_cell(r['gbps'], peak_gbps, 7)} GB/s "
            f"{_cell(r['tflops'], peak_tflops, 7)} TF/s  {name[:100]}"
            for name, r in rows[:top]]


def idle_by_span(path: str, out=None) -> Dict:
    """The device's idle time by the innermost program span open over it.

    The window runs from the trace's first device event or program span
    to its last; the idle time is the window less the union of the device
    events. Each idle part goes, by time, to the innermost "sbc:" span
    open over it (the latest to begin), "(no span)" where none is. Print
    the table; return {"window_ms", "idle_ms", "by_span": {name: ms}}.
    out: a text stream (stdout)."""
    out = out or sys.stdout
    busy, spans = [], []
    for e in _complete_events(path):
        s = float(e["ts"])
        t = (s, s + float(e.get("dur", 0.0)))
        if e.get("cat") in DEVICE_CATEGORIES:
            busy.append(t)
        elif (e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(SPAN_PREFIX)):
            spans.append((t[0], t[1], e["name"][len(SPAN_PREFIX):]))
    ends = busy + [sp[:2] for sp in spans]
    by = collections.Counter()
    if ends:
        lo, hi = min(s for s, _ in ends), max(e for _, e in ends)
        idle, at = [], lo
        for s, e in sorted(busy):
            if s > at:
                idle.append((at, s))
            at = max(at, e)
        if at < hi:
            idle.append((at, hi))
        segments, k = _innermost(spans), 0
        for a, b in idle:
            while k < len(segments) and segments[k][1] <= a:
                k += 1
            covered, j = 0.0, k
            while j < len(segments) and segments[j][0] < b:
                s, e, name = segments[j]
                part = min(b, e) - max(a, s)
                if part > 0:
                    by[name] += part
                    covered += part
                j += 1
            if b - a > covered:
                by["(no span)"] += b - a - covered
    summary = {"window_ms": (hi - lo) / 1e3 if ends else 0.0,
               "idle_ms": sum(by.values()) / 1e3,
               "by_span": {k: v / 1e3 for k, v in by.most_common()}}
    print(f"\n== device idle by program span: {summary['idle_ms']:.3f} ms "
          f"of a {summary['window_ms']:.3f} ms window ==", file=out)
    for name, ms in summary["by_span"].items():
        share = ms / summary["window_ms"] if summary["window_ms"] else 0.0
        print(f"{100 * share:6.1f}%  {ms:9.3f} ms  {name}", file=out)
    return summary


def _innermost(spans) -> List[Tuple[float, float, str]]:
    """(start, end, name) in time order where some span is open: the name
    of the innermost one (the latest to begin; of two that begin
    together, the one that ends first)."""
    spans = sorted(spans)
    marks = sorted({t for s, e, _ in spans for t in (s, e)})
    out, open_, i = [], [], 0
    for a, b in zip(marks, marks[1:]):
        while i < len(spans) and spans[i][0] <= a:
            s, e, name = spans[i]
            heapq.heappush(open_, (-s, e, i, name))
            i += 1
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        if open_:
            out.append((a, b, open_[0][3]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace", help="chrome trace (.json or .json.gz) or a "
                                 "directory holding *.pt.trace.json[.gz]")
    p.add_argument("--peak-gbps", type=float, default=H100_PEAK_GBPS,
                   help="memory peak in GB/s (default: the datasheet peak "
                        "of the NVIDIA H100 80GB HBM3 at 700 W, 3,350)")
    p.add_argument("--peak-tflops", type=float, default=H100_PEAK_TFLOPS_BF16,
                   help="dense bf16 tensor-core peak in TFLOP/s (default: "
                        "the datasheet peak of the NVIDIA H100 80GB HBM3 at "
                        "700 W, 989)")
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)
    summarize(args.trace, args.peak_gbps, args.peak_tflops, args.top)
    idle_by_span(args.trace)


if __name__ == "__main__":
    main()
