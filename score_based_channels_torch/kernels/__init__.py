"""Hand-written Hopper kernels of the port, each beside its plain version."""

from . import (conv, conv_chain, conv_im2col, eigmax, instance_norm,
               ldpc_minsum, max_pool, mean_pool)

KERNEL_MODULES = {"conv2d_taps": conv, "instance_norm_plus": instance_norm,
                  "ldpc_minsum": ldpc_minsum, "conv_im2col": conv_im2col,
                  "conv_chain": conv_chain, "pilot_eigmax": eigmax,
                  "max_pool_5x5": max_pool, "mean_pool_2x2": mean_pool}
GRAD_MODULES = {"conv2d_taps": conv, "instance_norm_plus": instance_norm}
# launches of a kernel's second route, counted among the kernel's own
ROUTE_COUNTS = {"conv2d_taps.wide": conv.WIDE_COUNTS,
                "conv2d_taps.f32_wide": conv.F32_WIDE_COUNTS,
                "conv2d_taps.f32_wide.dgrad": conv.F32_WIDE_DGRAD_COUNTS,
                "instance_norm_plus.two_pass": instance_norm.TWO_PASS_COUNTS}


def reset_counts() -> None:
    """Set every kernel's launch count and plain-call count, and the
    gradient counts of the conv and norm, to 0."""
    for d in [m.COUNTS for m in KERNEL_MODULES.values()] + [
            m.GRAD_COUNTS for m in GRAD_MODULES.values()] + list(
                ROUTE_COUNTS.values()):
        for k in d:
            d[k] = 0


def _launch_counts(name: str) -> dict:
    return (ROUTE_COUNTS[name] if name in ROUTE_COUNTS
            else KERNEL_MODULES[name].COUNTS)


def counts() -> dict:
    """{kernel name: {"launches": n, "plain": n}} since the last reset
    ("max_pool_5x5" also {"autograd": n}, its calls on the library's pool
    under grad; "mean_pool_2x2" too), and {route name: {"launches": n}} of
    each kernel's second route (those launches are counted under the
    kernel's name too)."""
    out = {name: dict(mod.COUNTS) for name, mod in KERNEL_MODULES.items()}
    out.update({name: dict(c) for name, c in ROUTE_COUNTS.items()})
    return out


def add_launches(launches: dict, times: int = 1) -> None:
    """Add times x launches[name] to each kernel's launch count. A CUDA
    graph's replay runs the launches that its capture recorded without
    the wrappers, so its runner counts them here, once a replay (times
    -1 takes back what the wrappers counted while the capture recorded:
    a capture launches nothing)."""
    for name, n in launches.items():
        _launch_counts(name)["launches"] += times * n


def grad_counts() -> dict:
    """{"conv2d_taps": {"functions", "dgrad"}, "instance_norm_plus":
    {"functions", "backward"}} since the last reset: autograd Functions
    built on the card, and their backward work."""
    return {name: dict(mod.GRAD_COUNTS) for name, mod in GRAD_MODULES.items()}


def add_grad_counts(recorded: dict, times: int = 1) -> None:
    """Add times x recorded[name][key] to each gradient count, as
    `add_launches` does for launches: a replay of a captured training
    step runs the forward and backward that its capture recorded without
    building an autograd Function, so its runner counts them here, once a
    replay (times -1 takes back what the capture counted)."""
    for name, work in recorded.items():
        counts = GRAD_MODULES[name].GRAD_COUNTS
        for key, n in work.items():
            counts[key] += times * n
