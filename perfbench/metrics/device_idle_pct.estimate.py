"""device_idle_pct.estimate: the share of the traced unit's wall time in which
no operation ran on the card (100 - union of the device intervals over
the wall time on the host's clock). Moves estimates_per_s."""


def read(sl):
    if not sl.device_ops or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.wall_s)
