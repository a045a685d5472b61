"""device_idle_pct.inpaint: the share of the traced inpainting run's wall
time in which no operation ran on the card. Moves estimates_per_s."""

from perfbench import harness

read = harness.metric_module("device_idle_pct.estimate").read
