"""device_idle_pct.host_prep.train: device_idle_pct.host_prep.estimate's
reading (the card's idle share under the program's host_prep spans) in
the training cells. Moves train_steps_per_s."""

from perfbench import harness

read = harness.metric_module("device_idle_pct.host_prep.estimate").read
