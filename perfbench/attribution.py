"""The card's idle time in a traced slice, put down to the program's spans.

The program records its own host work as spans while a profiler runs
(`score_based_channels_torch/utils/spans.py`: name, start and end in Unix
nanoseconds, the clock of the profiler's events, so of `Slice`'s too). The
idle intervals are the parts of the slice's [t0, t1] that no device
operation covers (the complement of `Slice.intervals()`). Each is split
exactly, by time, among the innermost program span open over each part of
it; the parts under no program span are "unattributed". A span counts by
its group (`GROUPS`): what kind of host work held the card idle.

  capture    a graph's eager warm-up run and its capture
  host_prep  draws, padding, the host's batch, copies into a runner's
             buffers
  launch     a runner's run, its levels and steps, a graph's replay, the
             validation loss
  readback   results copied back to the host

A span whose name `GROUPS` does not list is passed over: the innermost
listed span around it takes its time. A program without the spans module
(a checkout older than it) gives no reading.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

GROUPS = {
    "graph.warm_up": "capture",
    "graph.capture": "capture",
    "graph.replay": "launch",
    "sweep.draws": "host_prep",
    "sweep.pad": "host_prep",
    "sweep.readback": "readback",
    "sampler.run": "launch",
    "sampler.load": "host_prep",
    "sampler.level": "launch",
    "dsm.run": "launch",
    "dsm.load": "host_prep",
    "dsm.step": "launch",
    "dsm.eval_loss": "launch",
    "ldamp.run": "launch",
    "ldamp.load": "host_prep",
    "ldamp.step": "launch",
    "data.sample_batch": "host_prep",
}
KINDS = ("capture", "host_prep", "launch", "readback", "unattributed")

_last: list = [None, None]   # the last slice read and its split


def program_spans(sl) -> Optional[list]:
    """The program's spans that overlap the slice, or None where the
    program records none."""
    try:
        from score_based_channels_torch.utils import spans
    except ImportError:
        return None
    return spans.recorded(sl.t0, sl.t1)


def idle_intervals(sl) -> List[Tuple[int, int]]:
    """The parts of [sl.t0, sl.t1] in which no device operation ran."""
    out, at = [], sl.t0
    for s, e in sl.intervals():
        if s >= sl.t1:
            break
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < sl.t1:
        out.append((at, sl.t1))
    return out


def innermost(spans) -> List[Tuple[int, int, str]]:
    """(start, end, group) in time order, where some listed span is open:
    the group of the innermost one (the latest to begin; of two that
    begin together, the one that ends first)."""
    listed = sorted((s for s in spans if s.name in GROUPS),
                    key=lambda s: s.start_ns)
    marks = sorted({t for s in listed for t in (s.start_ns, s.end_ns)})
    out, open_, i = [], [], 0
    for a, b in zip(marks, marks[1:]):
        while i < len(listed) and listed[i].start_ns <= a:
            s = listed[i]
            heapq.heappush(open_, (-s.start_ns, s.end_ns, i, GROUPS[s.name]))
            i += 1
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        if open_:
            out.append((a, b, open_[0][3]))
    return out


def split(idle: List[Tuple[int, int]],
          segments: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of the idle intervals under each group's segments, and
    under none ("unattributed"); both lists in time order, neither
    overlapping itself."""
    out = dict.fromkeys(KINDS, 0.0)
    k = 0
    for a, b in idle:
        covered = 0
        while k < len(segments) and segments[k][1] <= a:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < b:
            s, e, group = segments[j]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[group] += part / 1e9
                covered += part
            j += 1
        out["unattributed"] += (b - a - covered) / 1e9
    return out


def idle_seconds(sl) -> Optional[Dict[str, float]]:
    """The slice's idle seconds by group, or None where the program
    records no spans or the slice holds no device operation."""
    if _last[0] is not sl:
        spans = program_spans(sl)
        got = None
        if spans is not None and sl.device_ops and sl.wall_s > 0:
            got = split(idle_intervals(sl), innermost(spans))
        _last[:] = [sl, got]
    return _last[1]


def idle_pct(sl, kind: str) -> Optional[float]:
    """The group's idle seconds over the slice's wall time, in %."""
    got = idle_seconds(sl)
    return None if got is None else 100.0 * got[kind] / sl.wall_s
