"""roofline.conv2d_taps.inpaint: the conv kernel (kernels/conv.py ->
csrc/conv2d_taps.cu and its wide route, csrc/conv2d_taps_wide.cu) against
its roofline over the traced inpainting run: each launch's least time (the
larger of its operations over 989 TFLOP/s and its bytes over 3.35 TB/s,
from the shape table and `work.py`) summed over the unit's forwards, over
the device time of every conv2d_taps kernel. None where the unit's launch
counters disagree with the shape table (or the program has no wide-route
counter). Moves estimates_per_s."""

from perfbench import work

KERNELS = ("conv2d_taps_wgmma_kernel", "conv2d_taps_wide_kernel",
           "conv2d_taps_f32_kernel")


def read(sl):
    n = sl.work.get("launches", {})
    if ("conv2d_taps.wide" not in n
            or n.get("conv2d_taps") != work.counts(sl.work)["conv"]):
        return None
    t = sl.time_of(lambda name: any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return 100.0 * work.roofline_seconds(work.conv_launches(sl.work),
                                         sl.work["dtype"]) / t
