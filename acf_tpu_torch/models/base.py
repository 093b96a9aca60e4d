"""Model protocol (counterpart of ``acf_tpu/models/base.py``).

A model object holds only hyperparameters; params are a ``dict[str, Tensor]``
tree shaped like the JAX pytree. A model exposes

  * ``init_params(generator, device) -> params``
  * ``loss(params, batch, generator) -> (scalar, aux)``, differentiable
  * ``score_all(params, users, hists) -> [B, num_items]``
  * ``score_some(params, users, hists, items) -> [B, M]``
  * ``factored_scorer() -> (user_repr_fn, table_fn) | None``

Sequence models (:class:`SequenceModel`) read each user's last ``maxlen``
history items from ``hists`` and train on windowed sequences
(``batch_kind == "seq"``); pairwise models on (user, pos, neg) triples
(``batch_kind == "pair"``).
"""

from __future__ import annotations

import copy
import dataclasses

import torch


def row_normalize(x, eps: float = 1e-12):
    """Row-wise L2 normalization, ``tf.nn.l2_normalize(x, 1)`` semantics
    (zero rows stay zero)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def softplus(x):
    """``log(1 + e^x)`` as the JAX package writes it, ``logaddexp(0, x)``
    (``torch.nn.functional.softplus`` rounds its gradient otherwise)."""
    return torch.logaddexp(torch.zeros_like(x), x)


def bpr_pair_loss(pos_scores, neg_scores):
    """The reference's numerically-stable BPR objective
    (evaluation_adv.py:160-162): ``sum(softplus(-(clip(pos - neg))))``."""
    diff = torch.clamp(pos_scores - neg_scores, -80.0, 1e8)
    return torch.sum(softplus(-diff))


def scatter_rows(num_rows: int, ids, rows):
    """[num_rows, ...] zeros with each row of ``rows`` added at its id of
    ``ids``: the accumulate form of ``index_put_``, which sums an id's
    duplicates in their order in ``ids``, the same on every run (on CUDA it
    sorts the ids, stably, and sums each run; ``index_add_`` adds there with
    atomics, in an order that changes between runs)."""
    out = rows.new_zeros((num_rows,) + tuple(rows.shape[1:]))
    return out.index_put_((ids.long(),), rows, accumulate=True)


def project_rows(d, eps, dim=-1):
    """Per-row L2 projection into the ε-ball:
    ``d * min(1, eps / max(||d||, 1e-12))``."""
    n = torch.sqrt(torch.sum(torch.square(d), dim=dim, keepdim=True))
    return d * torch.clamp(eps / torch.clamp(n, min=1e-12), max=1.0)


@dataclasses.dataclass(eq=False)
class PairwiseModel:
    """Base for models trained on (user, pos, neg) triples."""

    num_users: int
    num_items: int
    dim: int

    batch_kind = "pair"
    # A mesh (acf_tpu_torch.parallel.mesh.Mesh) when this copy of the model
    # computes one data rank's share of each loss (:func:`data_parallel`);
    # None on one device.
    data_mesh = None
    # whether the user representation of factored_scorer() reads the item
    # table (SASRec's does: the sharded evaluation then gathers it whole for
    # the representations)
    repr_reads_table = True

    def __getstate__(self):
        """The hyperparameters: what a method caches on the instance (the
        ``_fs`` closures of ``factored_scorer``) is left out, so a model
        pickles (to a rank of :mod:`acf_tpu_torch.parallel.launch`)."""
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def data_share(self, x):
        """``x``, a mean over this data rank's rows, as its share of the mean
        over the global batch (every data rank holds as many rows)."""
        return x if self.data_mesh is None else x / self.data_mesh.shape["data"]

    def data_sum(self, x):
        """``x`` summed over the data ranks, in place (``x`` itself on one
        device)."""
        if self.data_mesh is not None:
            self.data_mesh.all_reduce(x.view(-1), "data")
        return x

    def data_count(self, n: int) -> int:
        """``n``, this data rank's count of rows, as the global batch's
        (every data rank holds as many rows): a batch factor of a loss."""
        return n if self.data_mesh is None else n * self.data_mesh.shape["data"]

    def data_gather(self, x):
        """The global batch's rows of ``x``, this data rank's rows [n, ...]
        (``x`` itself on one device): one ``all_reduce`` of zeros that hold
        each rank's rows at its place."""
        if self.data_mesh is None:
            return x
        mesh = self.data_mesh
        out = x.new_zeros((self.data_count(x.shape[0]),) + tuple(x.shape[1:]))
        out[mesh.rows(out.shape[0])] = x
        return mesh.all_reduce(out, "data")

    def train_masks(self, generator, batch):
        """(masks, adv_masks): the dropout masks that one call of the
        training loss on ``batch`` draws from ``generator``, in its order
        (the training pass's, then an adversarial pass's), None where it
        draws none. The mesh epochs draw them for the global batch and hand
        each data rank its rows."""
        return None, None

    def init_params(self, generator: torch.Generator, device=None):
        raise NotImplementedError

    def loss(self, params, batch, generator=None):
        raise NotImplementedError

    def adv_target_loss(self, params, batch, generator=None, **masks):
        """Linearization target for FGSM/PGD perturbations: the
        UNREGULARIZED training loss. The reference's FGSM linearizes on the
        raw BPR/pointwise loss (evaluation_adv.py:192-203, SASRec.py:365-371),
        never on the regularized objective. The default returns the full
        loss (``masks``, a model's injected dropout masks, passed on);
        models that fold a regularizer into ``loss`` override."""
        return self.loss(params, batch, generator, **masks)[0]

    def primary_loss(self, loss, aux):
        """The differentiable primary (pre-regularizer) loss of a ``loss``
        call that returned ``(loss, aux)``: what the FGSM wrapper adds at the
        perturbed point. Default: ``aux["loss"]``, the JAX zoo's convention;
        models whose aux values are detached override."""
        return aux.get("loss", loss)

    def score_all(self, params, users, hists):
        raise NotImplementedError

    def score_some(self, params, users, hists, items):
        """Default: gather columns of the full-catalog scores."""
        scores = self.score_all(params, users, hists)
        return torch.gather(scores, 1, items)

    def factored_scorer(self):
        """(user_repr_fn, table_fn) when scores factor as
        ``user_repr(params,u,h) · item_table + bias`` — enables the rank-count
        kernel (:mod:`acf_tpu_torch.ops.ranking`). None otherwise.
        Implementations cache the returned closures on the instance."""
        return None


def data_parallel(model, mesh):
    """A copy of ``model`` whose losses are one data rank's share of the
    loss of the global batch, so that the shares of the ranks sum to the
    single-device loss (a sum stays a sum over the rank's rows, a mean over
    the batch is divided by the data-axis size, a count that normalises a
    loss is summed over the ranks first, and a batch factor is the global
    batch's), and whose FGSM directions come from the table gradients
    summed over the data ranks. A wrapped ``base`` (the FGSM wrapper's, the
    popularity adversaries') is copied the same way."""
    out = copy.copy(model)
    out.data_mesh = mesh
    if getattr(model, "base", None) is not None:
        out.base = data_parallel(model.base, mesh)
    return out


@dataclasses.dataclass(eq=False)
class SequenceModel(PairwiseModel):
    """Base for next-item models trained on windowed sequences of each
    user's last ``maxlen`` items."""

    maxlen: int = 50
    batch_kind = "seq"

    def loss_window(self, params, batch, generator=None, **kw):
        """``loss`` from the packed sampler form ``(users, window [B, T+1],
        neg [B, T])`` where ``seq = window[:, :-1]`` and ``pos =
        window[:, 1:]`` (:func:`acf_tpu_torch.sampling.sample_seq_window_batch`).
        Default: expand and delegate; models may override to share the
        seq/pos rows."""
        users, window, neg = batch
        return self.loss(params, (users, window[:, :-1], window[:, 1:], neg),
                         generator, **kw)
