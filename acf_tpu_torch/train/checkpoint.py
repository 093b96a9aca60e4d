"""npz checkpoints for param trees (the npz half of
``acf_tpu/train/checkpoint.py``).

One ``.npz`` of the flattened tree keyed by the '/'-joined leaf path — the
JAX package's ``path_name`` scheme (``"P"``, ``"Q"`` for MF; ``"a/0"`` for
a list under key ``a``) — so a file written by either package loads in the
other.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _flatten_with_names(tree, prefix=()):
    """[(name, leaf)] for every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for key, sub in items:
        out.extend(_flatten_with_names(sub, prefix + (key,)))
    return out


def save_params(path: str, params) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{name: leaf.detach().cpu().numpy()
                      for name, leaf in _flatten_with_names(params)})


def load_params(path: str, like):
    """Load into the structure of ``like`` (names must match); each leaf
    takes the dtype and device of its counterpart in ``like``."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        def load(tree, prefix=()):
            if isinstance(tree, dict):
                return {k: load(v, prefix + (str(k),)) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(load(v, prefix + (str(i),))
                                  for i, v in enumerate(tree))
            name = "/".join(prefix)
            arr = data[name]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"{path}: {name} has shape {arr.shape}, "
                                 f"expected {tuple(tree.shape)}")
            return torch.as_tensor(arr).to(device=tree.device, dtype=tree.dtype)

        return load(like)
