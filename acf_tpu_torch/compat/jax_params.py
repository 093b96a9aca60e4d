"""Carry params and optimizer states between the JAX package and the port
through numpy.

The JAX side hands over its pytree as numpy arrays (``np.asarray`` on each
leaf, e.g. ``jax.tree.map(np.asarray, params)``); the port's params are the
same tree of tensors. Dicts and lists/tuples are walked; leaves convert.

Optimizer states (:mod:`acf_tpu_torch.train.optim`) are dicts of the fields
of optax's first chained state: ``(ScaleByAdamState(count, mu, nu),
EmptyState())`` becomes ``{"count", "mu", "nu"}``, ``(ScaleByRssState(
sum_of_squares), EmptyState())`` becomes ``{"sum_of_squares"}`` and SGD's
``(EmptyState(), EmptyState())`` becomes ``{}``. A dict of such states keyed
by player, as APL keeps ``{"g": …, "c": …}``, carries key by key.
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


# the fields of optax's optimizer states that the port carries
OPT_FIELDS = frozenset(("count", "mu", "nu", "sum_of_squares"))


def is_opt_fields(state) -> bool:
    """True for one optimizer's state (a dict of optax fields, ``{}`` for
    SGD); False for a dict of such states keyed by player."""
    return set(state) <= OPT_FIELDS


def opt_state_from_numpy(state, device=None):
    """optax's state as numpy — a chain tuple, its first state, a dict of
    its fields, or a dict of those keyed by player — into the port's dict of
    fields (``count`` as int32) on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    if isinstance(state, dict) and not is_opt_fields(state):
        return {k: opt_state_from_numpy(v, dev) for k, v in state.items()}
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        state = state[0]  # a plain tuple is the chain: its first state holds the slots
    if isinstance(state, dict):
        fields = state
    else:
        fields = {f: getattr(state, f) for f in state._fields}
    return {f: (torch.as_tensor(np.array(v, dtype=np.int32), device=dev) if f == "count"
                else params_from_numpy(v, dev)) for f, v in fields.items()}


def opt_state_to_numpy(state):
    """The port's optimizer state as numpy: per optimizer, the dict of
    optax's fields (``optax.ScaleByRssState(**out)`` and
    ``optax.ScaleByAdamState(**out)`` rebuild the first chained state);
    per-player dicts key by key."""
    if not is_opt_fields(state):
        return {k: opt_state_to_numpy(v) for k, v in state.items()}
    return {f: (v.detach().cpu().numpy().astype(np.int32) if f == "count"
                else params_to_numpy(v)) for f, v in state.items()}
