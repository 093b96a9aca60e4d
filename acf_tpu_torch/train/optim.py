"""Adam, Adagrad and SGD as optax computes them (``optax.adam``,
``optax.adagrad``, ``optax.sgd``), written by hand on tensors.

``torch.optim`` keeps its state inside the optimizer and orders the
arithmetic differently (``torch.optim.Adagrad`` divides by
``sqrt(acc) + 1e-10``); here each state is a plain dict beside the params,
holding the fields of optax's first chained state, so the trainer can reset
or carry the slots between phases (``Trainer.switch_model``) and a
checkpoint holds them under the JAX package's names
(:mod:`acf_tpu_torch.compat.jax_params`, :mod:`acf_tpu_torch.train.checkpoint`).

Per leaf, with g the gradient:

  Adam (n the step count after the increment):
    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g² + b2 nu
    p  = p + (-lr) (mu / (1 - b1ⁿ)) / (sqrt(nu / (1 - b2ⁿ)) + eps)
  that is optax's update with its default ``eps_root`` of 0;
  Adagrad (``{"sum_of_squares"}``, starting at ``initial_accumulator_value``):
    acc = g² + acc;  p = p + (-lr) (rsqrt(acc + eps) g), 0 where acc is 0
  SGD (no state, ``{}``, as optax's ``EmptyState``):
    p = p + (-lr) g
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def grad_update(optimizer, params, opt_state, loss_fn, reduce=None):
    """One optimizer step: ``loss_fn(prm) -> (loss, aux)`` at ``params``
    (leaves not reached by the loss get a zero gradient), the gradient tree
    through ``reduce`` when given (the sum over data ranks), then
    ``optimizer.update``. Returns (params, opt_state, loss, aux)."""
    prm = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, aux = loss_fn(prm)
    leaves = tree_leaves(prm)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    grads = tree_unflatten(params, grads)
    if reduce is not None:
        grads = reduce(grads)
    params, opt_state = optimizer.update(grads, opt_state, params)
    return params, opt_state, loss.detach(), aux


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr, b1, b2, eps)``: ``init(params)`` and
    ``update(grads, state, params) -> (new_params, new_state)``."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params):
        """Zero moments shaped like ``params``, count 0 (int32, on the
        params' device)."""
        return {"count": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        n = count.to(torch.float32)
        # 1 - decay**count in f32, as optax's bias_correction computes it
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=n.device), n)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=n.device), n)
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])

        def step(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            return p + (-self.lr) * u

        return tree_map(step, params, mu, nu), {"count": count, "mu": mu, "nu": nu}


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Adam:
    """``optax.adam(lr, b1=b1, b2=b2, eps=eps)``."""
    return Adam(lr, b1, b2, eps)


@dataclasses.dataclass(frozen=True)
class Adagrad:
    """``optax.adagrad(lr, initial_accumulator_value, eps)``.

    The accumulator update and the order of the products are optax's. The
    reciprocal square root is ``torch.rsqrt``: XLA's CPU ``rsqrt`` is not
    correctly rounded and differs from it in the last bit for about a third
    of the inputs, so an update can differ from optax's by one ulp."""

    lr: float
    initial_accumulator_value: float = 0.1
    eps: float = 1e-7

    def init(self, params):
        return {"sum_of_squares": tree_map(
            lambda x: torch.full_like(x, self.initial_accumulator_value), params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        acc = tree_map(lambda g, t: g * g + t, grads, state["sum_of_squares"])

        def step(p, g, t):
            inv = torch.where(t > 0, torch.rsqrt(t + self.eps), 0.0)
            return p + (-self.lr) * (inv * g)

        return tree_map(step, params, grads, acc), {"sum_of_squares": acc}


def adagrad(lr: float, initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> Adagrad:
    """``optax.adagrad(lr, initial_accumulator_value, eps)``."""
    return Adagrad(lr, initial_accumulator_value, eps)


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(lr)`` without momentum: ``p + (-lr) g``, no state."""

    lr: float

    def init(self, params):
        return {}

    @torch.no_grad()
    def update(self, grads, state, params):
        return tree_map(lambda p, g: p + (-self.lr) * g, params, grads), state


def sgd(lr: float) -> SGD:
    """``optax.sgd(lr)``."""
    return SGD(lr)
