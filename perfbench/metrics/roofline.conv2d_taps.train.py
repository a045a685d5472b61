"""roofline.conv2d_taps.train: roofline.conv2d_taps.estimate's reading (the
conv kernel against its roofline) in the training cells, over the steps'
forward and input-gradient convs and any validation forwards in the traced
unit, whose launches `work.conv_launches` counts from the unit's work.
Moves train_steps_per_s."""

from perfbench import harness

read = harness.metric_module("roofline.conv2d_taps.estimate").read
