"""Generic FGSM/PGD adversarial-training wrapper (counterpart of
``acf_tpu/adversarial/fgsm.py``).

The recipe of APR (evaluation_adv.py:179-203) applied to any pair or
sequence model of the port: perturb embedding rows by ε times the
row-normalized gradient of the model's own unregularized loss
(``adv_target_loss``), then add the model's primary loss at the perturbed
point (its aux ``loss``) with weight ``reg_adv``; ``adv_steps > 1`` iterates
PGD-style (MSAP, arXiv:2010.01329). The perturbed leaves are every
top-level 2-D parameter whose leading dimension is the user or item count
(the embedding tables).

Use with the two-phase protocol like APR::

    clean = SASRec(U, I, d, maxlen=L)
    adv = FGSMAdversarial(U, I, d, base=SASRec(U, I, d, maxlen=L), eps=0.5)
    fit_two_phase(clean, adv, data, optimizer, cfg, adv_epoch=K)

Randomness: the JAX wrapper splits its key into one for the clean call (and
the linearization) and one for the perturbed call. Here one
:class:`torch.Generator` goes to the clean call and then to the perturbed
call, so each call draws its own dropout masks; ``masks`` and ``adv_masks``
hand them over instead (the clean and the perturbed pass's). A base with
``dropout_masks(generator, batch)`` (Caser, DSIN) gets both drawn up front
when they are not given, and the clean pass's masks go to its
linearization too, as the JAX wrapper's shared key does. The perturbed
addend is the base's aux ``loss``, the JAX package's convention, through
``base.primary_loss`` (SASRec's aux values are detached: it returns its
loss).

Under a mesh (:func:`~acf_tpu_torch.models.base.data_parallel`, which
copies the base too) the base's losses are this data rank's shares, so the
added adversarial loss is one too, and each direction is row-normalized
from the table gradient summed over the data ranks, as one device takes it
from the global batch.

A base's own epoch is not delegated, as in the JAX package: a sequence
model that brings one (Caser's sliding windows) trains under the wrapper
through the trainer's sequence epoch. A pair model's own epoch (APL's
minimax, the popularity players) is its only training procedure, so such a
base is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from acf_tpu_torch.models.base import PairwiseModel, project_rows, row_normalize
from acf_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(eq=False)
class FGSMAdversarial(PairwiseModel):
    base: Any = None
    eps: float = 0.5
    reg_adv: float = 1.0
    adv_steps: int = 1

    def __post_init__(self):
        # what is already adversarial, or is trained only by its own epoch
        # (APL, the popularity players), is refused, as the JAX package's
        # CLI refuses --fgsm for it
        if (isinstance(self.base, FGSMAdversarial) or getattr(self.base, "adversarial", False)
                or (hasattr(self.base, "make_epoch_fn")
                    and getattr(self.base, "batch_kind", "pair") != "seq")):
            raise ValueError(f"FGSMAdversarial does not wrap {type(self.base).__name__} "
                             "(already adversarial, or it brings its own epoch)")
        # delegate the trainer-facing surface to the base model
        self.batch_kind = getattr(self.base, "batch_kind", "pair")
        for attr in ("maxlen", "uses_full_hist", "dns", "eval_batch_users",
                     "repr_reads_table"):
            if hasattr(self.base, attr):
                setattr(self, attr, getattr(self.base, attr))
        if hasattr(self.base, "extra_device_data"):
            self.extra_device_data = self.base.extra_device_data
        if hasattr(self.base, "init_opt_state"):
            self.init_opt_state = self.base.init_opt_state
            self.opt_state_rows = self.base.opt_state_rows

    # -- delegation ----------------------------------------------------
    def init_params(self, generator: torch.Generator, device=None):
        return self.base.init_params(generator, device)

    def score_all(self, params, users, hists):
        return self.base.score_all(params, users, hists)

    def score_some(self, params, users, hists, items):
        return self.base.score_some(params, users, hists, items)

    def factored_scorer(self):
        fs = getattr(self.base, "factored_scorer", lambda: None)
        return fs()

    # -- adversarial objective ------------------------------------------
    def _leaf_names(self, params):
        names = [k for k, v in params.items()
                 if isinstance(v, torch.Tensor) and v.dim() == 2
                 and v.shape[0] in (self.num_users, self.num_items)]
        if not names:
            raise ValueError(
                "FGSMAdversarial found no embedding-like top-level leaves "
                f"in {list(params)}")
        return tuple(names)

    def deltas(self, params, batch, generator=None, masks=None):
        """ε-ball perturbations of the selected leaves, constant under the
        outer gradient: ``adv_steps`` steps of ε/adv_steps along the
        row-normalized gradient of ``base.adv_target_loss`` (the
        UNREGULARIZED loss, as APR linearizes on its raw BPR loss,
        evaluation_adv.py:162 vs 192-203) at the perturbed point, each row
        projected into the ε-ball. Each gradient is taken on detached
        copies with the other leaves constant, and summed over the data
        ranks before the row normalize; ``masks`` (the clean pass's dropout
        masks) go to the linearization when given."""
        names = self._leaf_names(params)
        fixed = tree_map(lambda x: x.detach(), params)
        alpha = self.eps / self.adv_steps
        delta = {k: torch.zeros_like(fixed[k]) for k in names}
        for _ in range(self.adv_steps):
            shifted = dict(fixed)
            for k in names:
                shifted[k] = (fixed[k] + delta[k]).requires_grad_(True)
            wanted = [shifted[k] for k in names]
            with torch.enable_grad():
                g = torch.autograd.grad(
                    self.base.adv_target_loss(shifted, batch, generator,
                                              **({} if masks is None else {"masks": masks})),
                    wanted, allow_unused=True)
            delta = {k: project_rows(delta[k] + alpha * row_normalize(
                self.data_sum(torch.zeros_like(w) if gk is None else gk)), self.eps)
                for k, w, gk in zip(names, wanted, g)}
        return delta

    def train_masks(self, generator, batch):
        """The clean pass's masks, then the perturbed pass's: a base with
        ``dropout_masks`` gets both drawn up front (:meth:`loss`), any other
        base draws its own in each of its two loss calls."""
        draw = getattr(self.base, "dropout_masks", None)
        if draw is not None:
            return draw(generator, batch), draw(generator, batch)
        return self.base.train_masks(generator, batch)[0], self.base.train_masks(
            generator, batch)[0]

    def loss(self, params, batch, generator=None, masks=None, adv_masks=None):
        """The base loss plus ``reg_adv`` times the base's primary,
        pre-regularizer loss at the perturbed point (``base.primary_loss``:
        its aux ``loss``, as the JAX wrapper reads it); aux adds ``loss_adv``
        and ``acc_adv`` (the base's ``acc`` there)."""
        draw = getattr(self.base, "dropout_masks", None)
        lin_masks = None
        if draw is not None:
            masks = draw(generator, batch) if masks is None else masks
            adv_masks = draw(generator, batch) if adv_masks is None else adv_masks
            lin_masks = masks
        loss, aux = self.base.loss(params, batch, generator,
                                   **({} if masks is None else {"masks": masks}))
        delta = self.deltas(params, batch, generator, lin_masks)
        perturbed = dict(params)
        for k, d in delta.items():
            perturbed[k] = params[k] + d
        loss_adv_full, aux_adv = self.base.loss(
            perturbed, batch, generator, **({} if adv_masks is None else {"masks": adv_masks}))
        loss_adv = self.base.primary_loss(loss_adv_full, aux_adv)
        aux = dict(aux)
        aux["loss_adv"] = loss_adv.detach()
        aux["acc_adv"] = aux_adv.get("acc", torch.zeros((), device=loss.device))
        return loss + self.reg_adv * loss_adv, aux
