"""Carry params between the JAX package and the port through numpy.

The JAX side hands over its pytree as numpy arrays (``np.asarray`` on each
leaf, e.g. ``jax.tree.map(np.asarray, params)``); the port's params are the
same tree of tensors. Dicts and lists/tuples are walked; leaves convert.
"""

from __future__ import annotations

import numpy as np
import torch

from acf_tpu_torch.device import resolve_device


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def params_from_numpy(tree, device=None):
    """Tree of numpy arrays → the same tree of tensors on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    return _map_tree(
        lambda x: torch.as_tensor(np.array(x, copy=True), device=dev), tree)


def params_to_numpy(tree):
    """Tree of tensors → the same tree of numpy arrays on the host."""
    return _map_tree(lambda x: x.detach().cpu().numpy(), tree)
