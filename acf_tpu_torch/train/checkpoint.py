"""npz checkpoints for param trees and full train states (the npz half of
``acf_tpu/train/checkpoint.py``).

One ``.npz`` of the flattened tree keyed by the '/'-joined leaf path — the
JAX package's ``path_name`` scheme (``"P"``, ``"Q"`` for MF; ``"a/0"`` for
a list under key ``a``) — so a file written by either package loads in the
other. A full train state (:func:`save_state`) holds ``params/…``, the
optimizer slots under the names optax's chained state takes in the JAX
package's snapshots (Adam's ``opt/0/.count``, ``opt/0/.mu/…``,
``opt/0/.nu/…``; Adagrad's ``opt/0/.sum_of_squares/…``; SGD has none; a
per-player state such as APL's under ``opt/g/…`` and ``opt/c/…``; the
sparse step's slots as ``opt/accP`` and ``opt/accQ``), and
``rng``, the trainer's
``torch.Generator`` state (the JAX snapshots hold a ``key`` instead, which
the port cannot use: restoring one keeps the current generator).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from acf_tpu_torch.compat.jax_params import is_opt_fields
from acf_tpu_torch.utils.tree import tree_unflatten


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


def _opt_names(opt_state, prefix="opt/"):
    """[(npz name, leaf)] of an optimizer state: the first chained state's
    fields under ``<prefix>0/.<field>``; per-player states under
    ``<prefix><player>/``; a model's own slot tensor (SparseMFBPR's
    ``accP``) under its key; nothing for a model without a state (the
    naive baselines' ``()``)."""
    if isinstance(opt_state, torch.Tensor):
        return [(prefix[:-1], opt_state)]
    if not isinstance(opt_state, dict):
        return []
    if not is_opt_fields(opt_state):
        return [x for k, v in opt_state.items() for x in _opt_names(v, f"{prefix}{k}/")]
    return [(f"{prefix}0/.{field}" + (f"/{n}" if n else ""), leaf)
            for field, tree in opt_state.items() for n, leaf in _flatten_with_names(tree)]


def state_arrays(params, opt_state, rng_state=None):
    """The npz arrays of a full train state, keyed as :func:`save_state`
    writes them."""
    out = {f"params/{n}": leaf.detach().cpu().numpy()
           for n, leaf in _flatten_with_names(params)}
    out.update({n: leaf.detach().cpu().numpy() for n, leaf in _opt_names(opt_state)})
    if rng_state is not None:
        out["rng"] = rng_state.cpu().numpy()
    return out


def save_state(path: str, params, opt_state, rng_state=None) -> None:
    """Params, optimizer slots and (optionally) the generator state in one
    npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **state_arrays(params, opt_state, rng_state))


def _load_tree(data, like, prefix, path):
    def load(tree, names=()):
        if isinstance(tree, dict):
            return {k: load(v, names + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(load(v, names + (str(i),)) for i, v in enumerate(tree))
        name = prefix + "/".join(names)
        arr = data[name]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"{path}: {name} has shape {arr.shape}, "
                             f"expected {tuple(tree.shape)}")
        return torch.as_tensor(arr).to(device=tree.device, dtype=tree.dtype)

    return load(like)


def load_state(path: str, params_like, opt_like):
    """(params, opt_state, rng_state or None) from a :func:`save_state` file
    or a JAX package snapshot, into the structures, dtypes and devices of
    the ``*_like`` trees."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        params = _load_tree(data, params_like, "params/", path)
        leaves = []
        for name, like in _opt_names(opt_like):
            arr = data[name]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{path}: {name} has shape {arr.shape}, "
                                 f"expected {tuple(like.shape)}")
            leaves.append(torch.as_tensor(arr).to(device=like.device, dtype=like.dtype))
        opt = tree_unflatten(opt_like, leaves)
        rng = torch.as_tensor(data["rng"]) if "rng" in data.files else None
    return params, opt, rng
