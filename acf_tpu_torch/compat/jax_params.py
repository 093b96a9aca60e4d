"""Carry params and Adam state between the JAX package and the port
through numpy.

The JAX side hands over its pytree as numpy arrays (``np.asarray`` on each
leaf, e.g. ``jax.tree.map(np.asarray, params)``); the port's params are the
same tree of tensors. Dicts and lists/tuples are walked; leaves convert.
optax's Adam state, ``(ScaleByAdamState(count, mu, nu), EmptyState())``,
becomes the port's ``{"count", "mu", "nu"}`` (:mod:`acf_tpu_torch.train.optim`)
and back.
"""

from __future__ import annotations

import numpy as np
import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.utils.tree import tree_map


def params_from_numpy(tree, device=None):
    """Tree of numpy arrays → the same tree of tensors on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    return tree_map(
        lambda x: torch.as_tensor(np.array(x, copy=True), device=dev), tree)


def params_to_numpy(tree):
    """Tree of tensors → the same tree of numpy arrays on the host."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def adam_state_from_numpy(state, device=None):
    """optax's Adam state as numpy — the chain tuple
    ``(ScaleByAdamState, EmptyState)``, a ``ScaleByAdamState``, or a dict
    with ``count``, ``mu``, ``nu`` — into the port's ``{"count", "mu",
    "nu"}`` on ``device`` (default ``cuda``)."""
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        state = state[0]  # a plain tuple is the chain: its first state holds the slots
    get = state.get if isinstance(state, dict) else lambda k: getattr(state, k)
    dev = resolve_device(device)
    count = torch.as_tensor(np.asarray(get("count"), dtype=np.int32), device=dev)
    return {"count": count, "mu": params_from_numpy(get("mu"), dev),
            "nu": params_from_numpy(get("nu"), dev)}


def adam_state_to_numpy(state):
    """The port's Adam state as ``{"count", "mu", "nu"}`` of numpy arrays,
    the fields of optax's ``ScaleByAdamState``
    (``(ScaleByAdamState(**out), EmptyState())`` is ``optax.adam``'s
    state)."""
    return {"count": state["count"].detach().cpu().numpy().astype(np.int32),
            "mu": params_to_numpy(state["mu"]), "nu": params_to_numpy(state["nu"])}
