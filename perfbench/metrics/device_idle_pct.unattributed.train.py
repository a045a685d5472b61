"""device_idle_pct.unattributed.train:
device_idle_pct.unattributed.estimate's reading (the card's idle share
under the program's unattributed spans) in the training cells. Moves
train_steps_per_s."""

from perfbench import harness

read = harness.metric_module("device_idle_pct.unattributed.estimate").read
