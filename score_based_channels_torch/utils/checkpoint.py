"""numpy-only reader of the JAX package's `.npz` checkpoints, the
counterpart of the JAX package's utils/checkpoint.py:73-90.

A checkpoint holds the flattened parameter trees under `params/...` and
`ema/...` ('/'-separated module paths) and `__meta__`: the UTF-8 JSON of
{"config": Config.to_dict(), "metadata": {...}}. Optimizer and extra
arrays, which only training reads, are not read here yet.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

from ..config import Config

_SEP = "/"


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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """-> dict(config, metadata, params, ema); params and ema are nested
    dicts of numpy arrays (ema None when absent)."""
    with np.load(path) as npz:
        meta = json.loads(bytes(npz["__meta__"].tobytes()).decode("utf-8"))
        return {
            "config": Config.from_dict(meta["config"]),
            "metadata": meta.get("metadata", {}),
            "params": _unflatten(npz, "params"),
            "ema": _unflatten(npz, "ema"),
        }
