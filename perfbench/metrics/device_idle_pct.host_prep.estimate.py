"""device_idle_pct.host_prep.estimate: the share of the traced unit's wall
time in which the card was idle while the innermost program span open
was of the group host_prep: host work before the card's next work: the
sweep's draws and init (`sweep.draws`), a chunk's padding and copies
(`sweep.pad`), a runner's copies into its buffers (`sampler.load`,
`dsm.load`, `ldamp.load`) and the host's batch (`data.sample_batch`).
Moves estimates_per_s. `perfbench/attribution.py` splits the idle time."""

from perfbench import attribution


def read(sl):
    return attribution.idle_pct(sl, "host_prep")
