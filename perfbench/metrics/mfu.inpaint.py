"""mfu.inpaint: the inpainting run as a share of the card's peak: the
model operations of the forwards the traced unit completed (every conv
over its live taps, from the benchmark's shape table of NCSNv2-Deepest at
its FFHQ widths; no elementwise work) over the unit's wall time, over the
bf16 tensor cores' 989 TFLOP/s. Moves estimates_per_s."""

from perfbench import harness

read = harness.metric_module("mfu.estimate").read
