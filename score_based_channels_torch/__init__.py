"""PyTorch/CUDA port of the JAX score-based channel estimator, for NVIDIA Hopper.

The JAX package beside it is the reference this port is held against; the
port imports none of it. Entry points run on the card unless the caller
passes device="cpu".
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
