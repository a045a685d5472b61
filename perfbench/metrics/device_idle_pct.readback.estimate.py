"""device_idle_pct.readback.estimate: the share of the traced unit's wall
time in which the card was idle while the innermost program span open
was of the group readback: the read-back of the trace and estimates
(`sweep.readback`). Moves estimates_per_s. `perfbench/attribution.py`
splits the idle time."""

from perfbench import attribution


def read(sl):
    return attribution.idle_pct(sl, "readback")
