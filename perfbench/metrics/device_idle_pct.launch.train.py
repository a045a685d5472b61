"""device_idle_pct.launch.train: device_idle_pct.launch.estimate's reading
(the card's idle share under the program's launch spans) in the training
cells. Moves train_steps_per_s."""

from perfbench import harness

read = harness.metric_module("device_idle_pct.launch.estimate").read
