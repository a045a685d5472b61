"""`.npz` checkpoints in the JAX package's format, the counterpart of its
utils/checkpoint.py:43-90: written by either package, read by both.

A checkpoint holds the flattened parameter trees under `params/...` and
`ema/...` ('/'-separated module paths, conv kernels (kh, kw, I, O)), the
optimizer's leaves under `opt/00000`, `opt/00001`, ... in optax's
flattening order, arrays under `extra/...`, and `__meta__`: the UTF-8 JSON
of {"config": Config.to_dict(), "metadata": {...}}.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from ..config import Config

_SEP = "/"


def _flatten(tree: Optional[Mapping], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, f"{path}{_SEP}{name}")
            else:
                out[f"{path}{_SEP}{name}"] = np.asarray(child)

    if tree is not None:
        walk(tree, prefix)
    return out


def _unflatten(npz, prefix: str) -> Optional[Dict[str, Any]]:
    tree: Dict[str, Any] = {}
    for k in npz.files:
        if not k.startswith(prefix + _SEP):
            continue
        *path, leaf = k[len(prefix) + 1:].split(_SEP)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(npz[k])
    return tree or None


def save_checkpoint(
    path: str,
    config: Config,
    params: Mapping,
    ema_params: Optional[Mapping] = None,
    opt_state_leaves: Optional[Sequence[np.ndarray]] = None,
    extra_arrays: Optional[Dict[str, np.ndarray]] = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a checkpoint to `path` (.npz). params and ema_params are nested
    dicts of arrays in the JAX package's layout
    (`models.state_dict_to_jax_params`); opt_state_leaves is stored
    positionally, as optax's leaves are."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    arrays.update(_flatten(params, "params"))
    arrays.update(_flatten(ema_params, "ema"))
    for i, leaf in enumerate(opt_state_leaves or ()):
        arrays[f"opt{_SEP}{i:05d}"] = np.asarray(leaf)
    for k, v in (extra_arrays or {}).items():
        arrays[f"extra{_SEP}{k}"] = np.asarray(v)
    meta = {"config": config.to_dict(), "metadata": metadata or {}}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """-> dict(config, metadata, params, ema, opt_leaves, extra); params and
    ema are nested dicts of numpy arrays (ema None when absent), opt_leaves
    the optimizer's leaves in order (None when absent)."""
    with np.load(path) as npz:
        meta = json.loads(bytes(npz["__meta__"].tobytes()).decode("utf-8"))
        opt_keys = sorted(k for k in npz.files if k.startswith("opt" + _SEP))
        return {
            "config": Config.from_dict(meta["config"]),
            "metadata": meta.get("metadata", {}),
            "params": _unflatten(npz, "params"),
            "ema": _unflatten(npz, "ema"),
            "opt_leaves": [np.asarray(npz[k]) for k in opt_keys] or None,
            "extra": {k[len("extra") + 1:]: np.asarray(npz[k])
                      for k in npz.files if k.startswith("extra" + _SEP)},
        }
