"""device_idle_pct.launch.estimate: the share of the traced unit's wall
time in which the card was idle while the innermost program span open
was of the group launch: a runner's run, levels and steps and a graph's
replay (`sampler.run`, `sampler.level`, `dsm.run`, `dsm.step`,
`dsm.eval_loss`, `ldamp.run`, `ldamp.step`, `graph.replay`) with no
inner span open. Moves estimates_per_s. `perfbench/attribution.py`
splits the idle time."""

from perfbench import attribution


def read(sl):
    return attribution.idle_pct(sl, "launch")
