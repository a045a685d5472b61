"""Score network, its blocks, and the JAX-parameter converter."""

from .convert import jax_params_to_state_dict
from .ncsnv2 import NCSNv2Deepest, make_score_model

__all__ = ["NCSNv2Deepest", "jax_params_to_state_dict", "make_score_model"]
