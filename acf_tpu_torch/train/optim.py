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

Under a mesh whose layout shards some leaves
(:func:`acf_tpu_torch.parallel.mesh.shard_params`) the trainer hands every
epoch :class:`Sharded`, the one place that knows the layout, in place of the
bare optimizer: it gives a step the leaves it reads whole (:func:`whole`),
and takes the whole gradient after the data reduce, keeps this rank's rows
and updates only its shard and its slots. Each update above is elementwise
(Adam's count a scalar), so a shard's update is the matching rows of the
whole update, bit for bit. Each optimizer says where its slots live
(``state_rows``, beside its ``init``), and a model that makes its own slots
(``init_opt_state``) says it beside them (``opt_state_rows``). That form
keeps the stored params and slots at 1/m a rank; the step's transient
gathered leaf and its gradient stay whole.
A step that reads its tables only at the batch's ids (the MF family's row
path) hands :meth:`Sharded.update_rows` gradients already in the layout.
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


class Sharded:
    """``inner`` (Adam, Adagrad or SGD) on params stored as ``layout`` (a
    :class:`~acf_tpu_torch.parallel.mesh.Layout`) says: slots made on the
    stored leaves, so a sharded leaf's slots are its shard's."""

    def __init__(self, inner, layout):
        self.inner = inner
        self.layout = layout

    def init(self, params):
        return self.inner.init(params)

    def state_rows(self, rows):
        return self.inner.state_rows(rows)

    def whole(self, params):
        """The leaves a step reads: every sharded leaf gathered whole."""
        return self.layout.gather(params)

    def update(self, grads, state, params):
        """``grads`` whole (after the data reduce): this rank's rows of each
        sharded leaf's gradient update its shard and its slots."""
        return self.inner.update(self.layout.own(grads), state, params)

    def update_rows(self, grads, state, params):
        """``grads`` already shaped as the params are stored (the row path)."""
        return self.inner.update(grads, state, params)

    def player(self, key, inner=None) -> "Sharded":
        """``inner`` (default this one's) on the params subtree ``key``."""
        return Sharded(self.inner if inner is None else inner, self.layout.sub(key))


def layout_of(optimizer):
    """The layout an optimizer updates in (:class:`Sharded`), else None."""
    return getattr(optimizer, "layout", None)


def whole(optimizer, params):
    """``params`` as a step reads them: gathered whole where ``optimizer``
    stores them sharded, else as they are."""
    return optimizer.whole(params) if isinstance(optimizer, Sharded) else params


def player(optimizer, key, inner=None):
    """``inner`` (default: ``optimizer`` itself) for the player ``key``'s
    params (APL's, IRGAN's, the popularity adversaries'), stored as
    ``optimizer`` stores them."""
    if isinstance(optimizer, Sharded):
        return optimizer.player(key, inner)
    return optimizer if inner is None else inner


def update_rows(optimizer, grads, state, params):
    """The update from gradients already shaped as ``params`` are stored."""
    if isinstance(optimizer, Sharded):
        return optimizer.update_rows(grads, state, params)
    return optimizer.update(grads, state, params)


def grad_update(optimizer, params, opt_state, loss_fn, reduce=None, read=None):
    """One optimizer step: ``loss_fn(prm) -> (loss, aux)`` at ``params``
    (read whole, :func:`whole`, or ``read`` when the caller has gathered
    them already; leaves not reached by the loss get a zero gradient), the
    gradient tree through ``reduce`` when given (the sum over data ranks),
    then ``optimizer.update``. Returns (params, opt_state, loss, aux)."""
    read = whole(optimizer, params) if read is None else read
    prm = tree_map(lambda x: x.detach().requires_grad_(True), read)
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

    def state_rows(self, rows):
        """Where each leaf of :meth:`init`'s state lives, for params whose
        leaves live as ``rows`` says (a :class:`~acf_tpu_torch.parallel.mesh.
        Layout`'s rows): the moments as their params, the count whole."""
        return {"count": None, "mu": rows, "nu": rows}

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

    def state_rows(self, rows):
        """As :meth:`Adam.state_rows`: the accumulators as their params."""
        return {"sum_of_squares": rows}

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

    def state_rows(self, rows):
        return {}

    @torch.no_grad()
    def update(self, grads, state, params):
        return tree_map(lambda p, g: p + (-self.lr) * g, params, grads), state


def sgd(lr: float) -> SGD:
    """``optax.sgd(lr)``."""
    return SGD(lr)
