"""Matrix-factorization models: MF-BPR (with its APR adversarial fields) and
pointwise MF (counterpart of ``acf_tpu/models/mf.py``).

The hyperparameter fields match the JAX dataclasses so configurations carry
across. :meth:`MFBPR.loss` is the clean BPR objective (the pretraining of
APL's generator); APR (``adversarial=True``), DNS (``dns > 1``), PGD
(``adv_steps > 1``) and ``PointwiseMF.loss`` are not ported yet (ROADMAP.md
Queue 1 item 3) and raise.
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import PairwiseModel, bpr_pair_loss

NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1 item 3)"


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

    def loss(self, params, batch, generator=None):
        """The clean BPR loss (summed over the batch) plus ``reg`` times
        mean(p² + q_pos² + q_neg²); aux ``loss`` (BPR alone) and ``acc``
        (the share of pairs with pos scored above neg)."""
        for flag, what in ((self.adversarial, "APR (adversarial=True)"),
                           (self.dns > 1, "DNS (dns > 1)"),
                           (self.adv_steps > 1, "multi-step FGSM (adv_steps > 1)")):
            if flag:
                raise NotImplementedError(f"MFBPR {what} {NOT_PORTED}")
        users, pos, neg = batch
        p = params["P"][users]
        qp = params["Q"][pos]
        qn = params["Q"][neg]
        pos_s = torch.sum(p * qp, dim=-1)
        neg_s = torch.sum(p * qn, dim=-1)
        loss = bpr_pair_loss(pos_s, neg_s)
        reg_term = torch.mean(torch.square(p) + torch.square(qp) + torch.square(qn))
        acc = torch.mean(((pos_s - neg_s) > 0).to(torch.float32))
        return loss + self.reg * reg_term, {"loss": loss, "acc": acc}


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

    def loss(self, params, batch, generator=None):
        raise NotImplementedError(f"PointwiseMF.loss {NOT_PORTED}")
