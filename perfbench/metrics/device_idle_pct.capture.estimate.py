"""device_idle_pct.capture.estimate: the share of the traced unit's wall
time in which the card was idle while the innermost program span open
was of the group capture: a graph's eager warm-up run or its capture
(`graph.warm_up`, `graph.capture`): in the estimate cells, the new
`PosteriorRunner` each sweep builds. Moves estimates_per_s.
`perfbench/attribution.py` splits the idle time."""

from perfbench import attribution


def read(sl):
    return attribution.idle_pct(sl, "capture")
