"""roofline.instance_norm_plus.inpaint: the InstanceNorm++ kernel
(kernels/instance_norm.py -> csrc/instance_norm_plus.cu and its two-pass
route, csrc/instance_norm_wide.cu) against its roofline over the traced
inpainting run: each launch's input and parameters read once and output
written once at 3.35 TB/s (from the shape table), over the device time of
both routes' kernels (the two-pass route's statistics, finalize and apply
kernels together). None where the unit's launch counters disagree with
the shape table (or the program has no two-pass counter). Moves
estimates_per_s."""

from perfbench import work

KERNELS = ("instance_norm_plus_kernel", "instance_norm_plus_regs_kernel",
           "instance_norm_plus_stats_kernel",
           "instance_norm_plus_finalize_kernel",
           "instance_norm_plus_apply_kernel")


def read(sl):
    n = sl.work.get("launches", {})
    if ("instance_norm_plus.two_pass" not in n
            or n.get("instance_norm_plus") != work.counts(sl.work)["norm"]):
        return None
    t = sl.time_of(lambda name: any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return 100.0 * work.roofline_seconds(work.norm_launches(sl.work),
                                         sl.work["dtype"], kind="norm") / t
