"""roofline.conv2d_taps.estimate: the conv kernel (kernels/conv.py ->
csrc/conv2d_taps.cu) against its roofline: over the forwards' convs
in the traced unit, the sum of each launch's least time (the larger of its
operations over the dtype's peak and its bytes over 3.35 TB/s, from the
benchmark's shape table and `work.py`), over the device time of the
kernels named below. Moves estimates_per_s."""

from perfbench import work

KERNELS = ("conv2d_taps_wgmma_kernel", "conv2d_taps_f32_kernel")


def read(sl):
    t = sl.time_of(lambda name: any(k in name for k in KERNELS))
    if t <= 0:
        return None
    dtype = sl.work["dtype"]
    return 100.0 * work.roofline_seconds(work.conv_launches(sl.work),
                                         dtype) / t
