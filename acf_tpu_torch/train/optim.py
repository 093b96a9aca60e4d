"""Adam as optax computes it (``optax.adam``), written by hand on tensors.

``torch.optim.Adam`` keeps its state inside the optimizer and applies
``eps`` and the bias corrections in another order; here the state is a
plain tree ``{"count", "mu", "nu"}`` beside the params, so the trainer can
reset or carry the slots between phases (``Trainer.switch_model``) and a
checkpoint holds them under the JAX package's names
(:mod:`acf_tpu_torch.compat.jax_params`).

Per leaf, with g the gradient and n the step count after the increment:

  mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g² + b2 nu
  p  = p + (-lr) (mu / (1 - b1ⁿ)) / (sqrt(nu / (1 - b2ⁿ)) + eps)

that is optax's update with its default ``eps_root`` of 0.
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.utils.tree import tree_leaves, tree_map


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
