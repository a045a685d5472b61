"""Hand-written Hopper kernels of the port, each beside its plain version."""

from . import conv, conv_chain, conv_im2col, eigmax, instance_norm, ldpc_minsum

KERNEL_MODULES = {"conv2d_taps": conv, "instance_norm_plus": instance_norm,
                  "ldpc_minsum": ldpc_minsum, "conv_im2col": conv_im2col,
                  "conv_chain": conv_chain, "pilot_eigmax": eigmax}
GRAD_MODULES = {"conv2d_taps": conv, "instance_norm_plus": instance_norm}


def reset_counts() -> None:
    """Set every kernel's launch count and plain-call count, and the
    gradient counts of the conv and norm, to 0."""
    for d in [m.COUNTS for m in KERNEL_MODULES.values()] + [
            m.GRAD_COUNTS for m in GRAD_MODULES.values()]:
        for k in d:
            d[k] = 0


def counts() -> dict:
    """{kernel name: {"launches": n, "plain": n}} since the last reset."""
    return {name: dict(mod.COUNTS) for name, mod in KERNEL_MODULES.items()}


def add_launches(launches: dict, times: int = 1) -> None:
    """Add times x launches[name] to each kernel's launch count. A CUDA
    graph's replay runs the launches that its capture recorded without
    the wrappers, so its runner counts them here, once a replay (times
    -1 takes back what the wrappers counted while the capture recorded:
    a capture launches nothing)."""
    for name, n in launches.items():
        KERNEL_MODULES[name].COUNTS["launches"] += times * n


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
