"""roofline.instance_norm_plus.estimate: the InstanceNorm++ kernel
(kernels/instance_norm.py -> csrc/instance_norm_plus.cu) against its
roofline: each launch's input and parameters read once and output
written once at 3.35 TB/s (from the benchmark's shape table), summed over
the traced sweep's forwards, over the device time of the kernels named
below. Moves estimates_per_s."""

from perfbench import work

KERNELS = ("instance_norm_plus_kernel", "instance_norm_plus_regs_kernel")


def read(sl):
    t = sl.time_of(lambda name: any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return 100.0 * work.roofline_seconds(work.norm_launches(sl.work),
                                         sl.work["dtype"], kind="norm") / t
