"""Hand-written Hopper kernels of the port, each beside its plain version."""

from . import conv, conv_chain, conv_im2col, instance_norm, ldpc_minsum

KERNEL_MODULES = {"conv2d_taps": conv, "instance_norm_plus": instance_norm,
                  "ldpc_minsum": ldpc_minsum, "conv_im2col": conv_im2col,
                  "conv_chain": conv_chain}


def reset_counts() -> None:
    """Set every kernel's launch count and plain-call count to 0."""
    for mod in KERNEL_MODULES.values():
        for k in mod.COUNTS:
            mod.COUNTS[k] = 0


def counts() -> dict:
    """{kernel name: {"launches": n, "plain": n}} since the last reset."""
    return {name: dict(mod.COUNTS) for name, mod in KERNEL_MODULES.items()}
