"""device_idle_pct.train: device_idle_pct.estimate's reading (the share of
the traced unit's wall time in which no operation ran on the card) in the
training cells. Moves train_steps_per_s."""

from perfbench import harness

read = harness.metric_module("device_idle_pct.estimate").read
