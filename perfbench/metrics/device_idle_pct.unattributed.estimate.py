"""device_idle_pct.unattributed.estimate: the share of the traced unit's
wall time in which the card was idle and no program span was open: the
benchmark driver's own host work, and the program's outside its spans.
Moves estimates_per_s. `perfbench/attribution.py` splits the idle time."""

from perfbench import attribution


def read(sl):
    return attribution.idle_pct(sl, "unattributed")
