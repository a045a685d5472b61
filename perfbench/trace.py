"""A traced slice of a run: the device's operations and the host's spans
over one whole unit of work, read from `torch.profiler` (CUPTI).

`Slice` holds what the per-layer metrics read: every device operation
(kernel, copy, set) with its start and length, the benchmark's own host
spans (`span`, recorded with `torch.profiler.record_function` under the
prefix "pb:"), the wall time of the slice on the host's clock, and the
work the driver says the slice did. Busy time is the union of the device
intervals, so two operations that overlap on two streams count once.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time
from typing import Callable, List, Tuple

import torch

SPAN_PREFIX = "pb:"


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own, seen by the traced slice."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclasses.dataclass
class Slice:
    wall_s: float
    device_ops: List[Tuple[str, int, int]]   # (name, start ns, end ns)
    spans: List[Tuple[str, int, int]]        # (name, start ns, end ns)
    work: dict
    t0: int = 0   # the slice's bounds on the trace's clock (ns)
    t1: int = 0

    def intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, in order."""
        out: List[List[int]] = []
        for _, s, e in sorted(self.device_ops, key=lambda t: t[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def time_of(self, match: Callable[[str], bool]) -> float:
        """Seconds of the device operations whose name `match` accepts
        (summed: one stream runs each such kernel of this program)."""
        return sum(e - s for n, s, e in self.device_ops if match(n)) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by = collections.Counter()
        for name, s, e in self.device_ops:
            by[name] += (e - s) / 1e9
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle time of the device, summed by the innermost host span open
        at each gap's middle ("no span" between spans), largest first."""
        iv = self.intervals()
        if not iv:
            return []
        spans = sorted(self.spans, key=lambda t: t[1])
        starts = [s for _, s, _ in spans]
        by = collections.Counter()
        edges = [(self.t0, iv[0][0])] + [(a[1], b[0]) for a, b in
                                         zip(iv, iv[1:])] + [(iv[-1][1],
                                                              self.t1)]
        for a, b in edges:
            if b <= a:
                continue
            mid = (a + b) // 2
            inner, width = "no span", None
            for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                name, s, e = spans[k]
                if s <= mid < e and (width is None or e - s < width):
                    inner, width = name, e - s
            by[inner] += (b - a) / 1e9
        return [[k, v] for k, v in by.most_common(n)]


def traced(fn: Callable[[], dict]) -> Slice:
    """Run fn() (one whole unit; it returns the unit's work counts) under
    the profiler, the card synchronised before and after."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("slice"):
            t0 = time.perf_counter()
            work = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    sl = Slice(wall, [], [], work)
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # a record_function span is mirrored on the device's timeline
            if not ev.is_user_annotation():
                sl.device_ops.append((name, start, end))
        elif name.startswith(SPAN_PREFIX):
            sl.spans.append((name[len(SPAN_PREFIX):], start, end))
            if name == SPAN_PREFIX + "slice":
                sl.t0, sl.t1 = start, end
    return sl
