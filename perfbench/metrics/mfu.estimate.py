"""mfu.estimate: the sampler's whole level step as a share of the card's
peak: the model operations of the forwards the traced sweep completed
(every conv over its live taps, from the benchmark's shape table; no
elementwise work) over the sweep's wall time, over the peak of the
network's dtype (bf16 tensor cores 989 TFLOP/s, f32 67 TFLOP/s).
Moves estimates_per_s."""

from perfbench import work


def read(sl):
    if "forward" not in sl.work or sl.wall_s <= 0:
        return None
    dtype = sl.work["dtype"]
    return 100.0 * work.model_flops(sl.work) / sl.wall_s / \
        work.PEAK_FLOPS[dtype]
