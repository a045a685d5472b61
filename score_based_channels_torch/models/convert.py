"""JAX parameter tree -> PyTorch state dict, by the rule of
the JAX package's models/torch_compat.py:67-100.

  params['res1_0']['conv1']['kernel'] (kh,kw,I,O) -> 'res1.0.conv1.weight' (O,I,kh,kw)
  RCU's '{i}_{j}_conv', norm alpha/gamma/beta, biases -> same names

Digit-suffixed names become ModuleList indices only for the list
containers of the reference (res*, convs, adapt_convs).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_LIST_PARENTS = ("res1", "res2", "res3", "res31", "res4", "res5",
                 "convs", "adapt_convs")


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (a Flax `params` tree, or a checkpoint's) ->
    flat state dict of float32 CPU tensors that loads with strict=True."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            toks = list(path)
            base, _, idx = name.rpartition("_")
            if idx.isdigit() and base in _LIST_PARENTS:
                toks += [base, idx]
            else:
                toks.append(name)
            if isinstance(child, Mapping):
                walk(child, toks)
                continue
            arr = np.asarray(child, dtype=np.float32)
            if toks[-1] == "kernel":
                toks[-1] = "weight"
                if arr.ndim == 4:
                    arr = np.transpose(arr, (3, 2, 0, 1))
                elif arr.ndim == 2:
                    arr = arr.T
            out[".".join(toks)] = torch.tensor(arr)

    walk(params, [])
    return out
