"""roofline.instance_norm_plus.train_ffhq: the InstanceNorm++ kernel's
forward (kernels/instance_norm.py -> csrc/instance_norm_wide.cu, the
two-pass route every norm of the FFHQ model takes) against its roofline
over the traced FFHQ training unit: each forward norm's input and
parameters read once and output written once at 3.35 TB/s (from the
shape table), over the device time of the norm kernels (the backward is
torch ops, not counted). None where the unit's launch counters disagree
with the shape table. Moves train_steps_per_s."""

from perfbench import harness

read = harness.metric_module("roofline.instance_norm_plus.inpaint").read
