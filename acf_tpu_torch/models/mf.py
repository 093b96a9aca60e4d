"""Matrix-factorization models: MF-BPR (with its APR adversarial fields) and
pointwise MF — the inference surface of ``acf_tpu/models/mf.py``.

The hyperparameter fields match the JAX dataclasses so configurations carry
across; the training losses come with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import PairwiseModel


def _trunc_normal(generator, shape, std=0.01):
    """tf.truncated_normal semantics: normal(0, std) truncated at 2 std.
    Drawn on the generator's device; the draws differ from ``jax.random``,
    the distribution matches."""
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(x, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def _mf_factored_scorer(model):
    if not hasattr(model, "_fs"):
        def user_repr(params, users, hists):
            return params["P"][users]

        def table(params):
            return params["Q"], None

        model._fs = (user_repr, table)
    return model._fs


@dataclasses.dataclass(eq=False)
class MFBPR(PairwiseModel):
    """MF with BPR loss; APR (FGSM on embedding rows) when ``adversarial``.

    Hyperparameter defaults follow the reference CLI (run_adv.py:15-54):
    Adagrad(lr=0.05), reg=0, eps=0.5, reg_adv=1.
    """

    reg: float = 0.0
    adversarial: bool = False
    eps: float = 0.5
    reg_adv: float = 1.0
    adv_mode: str = "grad"  # "grad" (FGSM) or "random"
    init_std: float = 0.01
    dns: int = 1  # >1 = hardest-of-k dynamic negative sampling
    adv_steps: int = 1  # >1 = multi-step (PGD-style) perturbation
    manual_grads_max_batch: int = 4096

    def init_params(self, generator: torch.Generator, device=None):
        dev = resolve_device(device)
        return {
            "P": _trunc_normal(generator, (self.num_users, self.dim),
                               self.init_std).to(dev),
            "Q": _trunc_normal(generator, (self.num_items, self.dim),
                               self.init_std).to(dev),
        }

    def score_all(self, params, users, hists):
        return params["P"][users] @ params["Q"].T

    def score_some(self, params, users, hists, items):
        p = params["P"][users]  # [B, d]
        q = params["Q"][items]  # [B, M, d]
        return torch.einsum("bd,bmd->bm", p, q)

    def factored_scorer(self):
        return _mf_factored_scorer(self)


@dataclasses.dataclass(eq=False)
class PointwiseMF(PairwiseModel):
    """Keras-style pointwise MF (reference MF.py:7-59): sigmoid(u·i) with
    binary cross-entropy."""

    init_scale: float = 0.05  # keras Embedding default: uniform(-0.05, 0.05)

    def init_params(self, generator: torch.Generator, device=None):
        dev = resolve_device(device)

        def uniform(shape):
            x = torch.empty(shape, dtype=torch.float32, device=generator.device)
            return x.uniform_(-self.init_scale, self.init_scale,
                              generator=generator).to(dev)

        return {"P": uniform((self.num_users, self.dim)),
                "Q": uniform((self.num_items, self.dim))}

    def score_all(self, params, users, hists):
        return params["P"][users] @ params["Q"].T

    def score_some(self, params, users, hists, items):
        return torch.einsum("bd,bmd->bm", params["P"][users], params["Q"][items])

    def factored_scorer(self):
        return _mf_factored_scorer(self)
