"""mfu.train: the whole training step as a share of the card's float32
peak (67 TFLOP/s, TF32 off): the model operations of the traced unit's
steps (forward, input and weight gradients of every conv and transposed
conv over its live taps, from the benchmark's shape table, and any
validation forwards; no elementwise work, no norms) over the unit's wall
time. Moves train_steps_per_s."""

from perfbench import work


def read(sl):
    if not ({"train", "unrolled"} & set(sl.work)) or sl.wall_s <= 0:
        return None
    return 100.0 * work.model_flops(sl.work) / sl.wall_s / \
        work.PEAK_FLOPS["float32"]
