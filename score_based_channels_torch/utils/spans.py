"""Spans of the port's own host work, recorded while a torch profiler runs.

`span(name)` marks a block of host work: a sweep's draws, a runner's
copies into its buffers, a level or step, a graph's capture.

- With no profiler running (the normal case, a timed loop included) it
  checks one flag and returns a shared no-op context: nothing is recorded.
- While a profiler runs (`torch.profiler.profile`, as a benchmark's traced
  slice or an operator's trace takes it), the block runs inside
  `torch.profiler.record_function("sbc:" + name)`, so it appears in an
  exported chrome trace, and a `Span` goes into a bounded ring in memory
  (the oldest dropped past `CAPACITY`). Its start and end are
  `time.time_ns()` stamps, the Unix clock onto which the profiler maps its
  host and device events, taken just after the profiler's event opens and
  just after it closes (a few us after the profiler's own stamps; a stamp
  taken before the close can come ~90 us before the profiler's on a card,
  where closing an event after CUDA calls takes that long). Its parent is the
  index of the innermost span open on the same thread when it began (None
  at the top).

`recorded(t0_ns, t1_ns)` returns the ring's spans that overlap a window.
The port opens spans where its host work happens: a sweep's draws, padding
and read-back (`eval/estimate.py`), the runners' runs, loads, levels and
steps (`diffusion/sampling.py`, `train/score.py`, `train/ldamp.py`), a
graph's warm-up, capture and replays (`_graph.py`) and the host's batch
(`data/dataset.py`).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

PREFIX = "sbc:"
CAPACITY = 65536


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]   # the index of the enclosing span
    index: int              # the span's own, in the order spans began


_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_indices = itertools.count()
_open = threading.local()
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


class _Recording:
    __slots__ = ("name", "parent", "index", "event", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.index = next(_indices)
        stack.append(self.index)
        self.event = torch.profiler.record_function(PREFIX + self.name)
        self.event.__enter__()
        self.start = time.time_ns()

    def __exit__(self, *exc) -> None:
        self.event.__exit__(*exc)
        end = time.time_ns()
        _open.stack.pop()
        _ring.append(Span(self.name, self.start, end, self.parent,
                          self.index))


def span(name: str):
    """A context that records the block as the span `name` while a torch
    profiler runs, and does nothing otherwise."""
    return _Recording(name) if _profiling() else _OFF


def recorded(t0_ns: int, t1_ns: int) -> List[Span]:
    """The recorded spans that overlap [t0_ns, t1_ns], in the order they
    began."""
    return sorted((s for s in list(_ring)
                   if s.end_ns > t0_ns and s.start_ns < t1_ns),
                  key=lambda s: s.index)
