"""Score network, its blocks, and the JAX-parameter converter."""

from .convert import jax_params_to_state_dict, state_dict_to_jax_params
from .ncsnv2 import NCSNv2, NCSNv2Deeper, NCSNv2Deepest, make_score_model

__all__ = ["NCSNv2", "NCSNv2Deeper", "NCSNv2Deepest",
           "jax_params_to_state_dict", "make_score_model",
           "state_dict_to_jax_params"]
