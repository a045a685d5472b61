"""roofline.conv2d_taps.train_ffhq: the f32 conv kernel (kernels/conv.py ->
csrc/conv2d_taps.cu: conv2d_taps_f32_kernel, its whole-row instances on
the resident route and its row-segment instances on the wide route)
against its roofline over the traced FFHQ training unit: each forward and
input-gradient launch of the unit's steps (`work.conv_launches`, from the shape table) at its least
time, the larger of its operations over 67 TFLOP/s and its bytes over
3.35 TB/s, summed, over the device time of its instances. None where the
unit's launch counters disagree with the shape table (or the program has
no f32 wide-route counter). Moves train_steps_per_s."""

from perfbench import work

KERNELS = ("conv2d_taps_f32_kernel",)


def read(sl):
    n = sl.work.get("launches", {})
    if ("conv2d_taps.f32_wide" not in n
            or n.get("conv2d_taps") != work.counts(sl.work)["conv"]):
        return None
    t = sl.time_of(lambda name: any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return 100.0 * work.roofline_seconds(work.conv_launches(sl.work),
                                         sl.work["dtype"]) / t
