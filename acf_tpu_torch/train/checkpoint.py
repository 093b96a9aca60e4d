"""npz checkpoints for param trees and full train states (the npz half of
``acf_tpu/train/checkpoint.py``).

One ``.npz`` of the flattened tree keyed by the '/'-joined leaf path — the
JAX package's ``path_name`` scheme (``"P"``, ``"Q"`` for MF; ``"a/0"`` for
a list under key ``a``) — so a file written by either package loads in the
other. A full train state (:func:`save_state`) holds ``params/…``, the Adam
slots under the names optax's ``(ScaleByAdamState(count, mu, nu),
EmptyState())`` takes in the JAX package's snapshots (``opt/0/.count``,
``opt/0/.mu/…``, ``opt/0/.nu/…``), and ``rng``, the trainer's
``torch.Generator`` state (the JAX snapshots hold a ``key`` instead, which
the port cannot use: restoring one keeps the current generator).
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


OPT_PREFIX = "opt/0/."  # optax's chain state (ScaleByAdamState, EmptyState)


def state_arrays(params, opt_state, rng_state=None):
    """The npz arrays of a full train state, keyed as :func:`save_state`
    writes them."""
    out = {f"params/{n}": leaf.detach().cpu().numpy()
           for n, leaf in _flatten_with_names(params)}
    out[OPT_PREFIX + "count"] = opt_state["count"].detach().cpu().numpy()
    for slot in ("mu", "nu"):
        out.update({f"{OPT_PREFIX}{slot}/{n}": leaf.detach().cpu().numpy()
                    for n, leaf in _flatten_with_names(opt_state[slot])})
    if rng_state is not None:
        out["rng"] = rng_state.cpu().numpy()
    return out


def save_state(path: str, params, opt_state, rng_state=None) -> None:
    """Params, Adam slots and (optionally) the generator state in one npz."""
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
        opt = {"count": _load_tree(data, opt_like["count"], OPT_PREFIX + "count", path),
               "mu": _load_tree(data, opt_like["mu"], OPT_PREFIX + "mu/", path),
               "nu": _load_tree(data, opt_like["nu"], OPT_PREFIX + "nu/", path)}
        rng = torch.as_tensor(data["rng"]) if "rng" in data.files else None
    return params, opt, rng
