"""JAX parameter tree <-> PyTorch state dict, by the rule of
the JAX package's models/torch_compat.py:34-100.

  params['res1_0']['conv1']['kernel'] (kh,kw,I,O) <-> 'res1.0.conv1.weight' (O,I,kh,kw)
  RCU's '{i}_{j}_conv', norm alpha/gamma/beta, biases -> same names

  a transposed conv's kernel (parent 'tconv'): the JAX package's ConvTranspose
  (transpose_kernel=False) applies its (kh,kw,I,O) kernel unflipped, torch's
  conv_transpose2d the adjoint of a conv: (I,O,kh,kw), spatially flipped
  a Dense kernel (in,out) <-> a Linear weight (out,in)
  the JAX models' batch statistics (`batch_stats` tree: BatchNorm
  mean/var) <-> the
  module's buffers of the same names (`jax_variables_to_state_dict`,
  `module_to_jax_variables`)

`load_reference_checkpoint` reads the reference's own `final_model.pt`
(the JAX package's models/torch_compat.py:103-112), whose state dict
already has the port's names.

Digit-suffixed names become ModuleList indices only for the list
containers of the reference (res*, convs, adapt_convs); the other way,
every ModuleList index joins its parent's name.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_LIST_PARENTS = ("res1", "res2", "res3", "res31", "res4", "res5",
                 "convs", "adapt_convs")
_TRANSPOSED = "tconv"  # parent name of a transposed conv's kernel


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
                if arr.ndim == 4 and toks[-2:-1] == [_TRANSPOSED]:
                    arr = np.ascontiguousarray(
                        np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1])
                elif arr.ndim == 4:
                    arr = np.transpose(arr, (3, 2, 0, 1))
                elif arr.ndim == 2:
                    arr = arr.T
            out[".".join(toks)] = torch.tensor(arr)

    walk(params, [])
    return out


def state_dict_to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Flat state dict -> nested dict of float32 numpy arrays (copies) in
    the JAX package's layout (conv kernels (kh, kw, I, O)), the tree its
    `load_checkpoint` and its model take."""
    params: Dict = {}
    for key, val in state_dict.items():
        arr = val.detach().cpu().float().numpy().copy()  # no alias of val
        toks: List[str] = []
        for t in key.split("."):
            if t.isdigit() and toks:
                toks[-1] = f"{toks[-1]}_{t}"
            else:
                toks.append(t)
        if toks[-1] == "weight":
            toks[-1] = "kernel"
            if arr.ndim == 4 and toks[-2:-1] == [_TRANSPOSED]:
                arr = np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 0, 1))
            elif arr.ndim == 4:
                arr = np.transpose(arr, (2, 3, 1, 0))
            elif arr.ndim == 2:
                arr = arr.T
        node = params
        for t in toks[:-1]:
            node = node.setdefault(t, {})
        node[toks[-1]] = np.ascontiguousarray(arr)
    return params


def jax_variables_to_state_dict(
        params: Mapping,
        batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """A JAX model's `params` and `batch_stats` trees -> one state dict:
    parameters and buffers (BatchNorm's running `mean` and `var`)."""
    def merge(a, b):
        out = dict(a)
        for k, v in b.items():
            out[k] = merge(out[k], v) if k in out else v
        return out

    return jax_params_to_state_dict(merge(params, batch_stats or {}))


def module_to_jax_variables(module: torch.nn.Module) -> Tuple[Dict, Dict]:
    """-> (params, batch_stats) in the JAX package's layout: the module's
    parameters and its buffers, each as `state_dict_to_jax_params` gives
    them ({} when the module has no buffers)."""
    return (state_dict_to_jax_params(dict(module.named_parameters())),
            state_dict_to_jax_params(dict(module.named_buffers())))


def tree_paths(tree: Mapping) -> List[Tuple[str, ...]]:
    """The leaf paths of a nested dict in the order in which the JAX
    package flattens it (keys sorted at every level)."""
    out: List[Tuple[str, ...]] = []

    def walk(node, path):
        for name in sorted(node):
            child = node[name]
            if isinstance(child, Mapping):
                walk(child, path + (name,))
            else:
                out.append(path + (name,))

    walk(tree, ())
    return out


def tree_leaves(tree: Mapping) -> list:
    """The leaves of a nested dict in `tree_paths` order."""
    out = []
    for path in tree_paths(tree):
        node = tree
        for t in path:
            node = node[t]
        out.append(node)
    return out


def tree_from_leaves(paths: List[Tuple[str, ...]], leaves) -> Dict:
    """The nested dict with `leaves` at `paths` (the inverse of reading
    `tree_paths` off a tree)."""
    tree: Dict = {}
    for path, leaf in zip(paths, leaves, strict=True):
        node = tree
        for t in path[:-1]:
            node = node.setdefault(t, {})
        node[path[-1]] = leaf
    return tree


def load_reference_checkpoint(path: str):
    """A reference `final_model.pt` (train_score.py:211-216: `model_state`,
    `config`, ...) -> (state dict, sigmas, raw config).

    The state dict holds float32 CPU tensors and loads into the port's
    NCSNv2Deepest with strict=True; the model's `sigmas` buffer, which the
    port's module does not keep, comes back apart as a float32 array
    (None when absent), as the JAX package's loader returns it."""
    contents = torch.load(path, map_location="cpu", weights_only=False)
    state, sigmas = {}, None
    for key, val in contents["model_state"].items():
        t = torch.as_tensor(val).detach().to("cpu", torch.float32)
        if key == "sigmas":
            sigmas = t.numpy().copy()
        else:
            state[key] = t.contiguous()
    return state, sigmas, contents.get("config")
