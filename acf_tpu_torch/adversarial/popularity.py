"""Popularity-discriminator adversarial training: AMF, AMF2, ABPR and ANeuMF
(counterpart of ``acf_tpu/adversarial/popularity.py``).

The reference attaches small MLP discriminators that classify popular and
rare user/item embeddings, and trains the recommender to confuse them
(label swap) while it still fits the interactions:

  * ``AdversarialMatrixFactorisation`` (reference MF.py:62-289): two
    discriminators on the user and item tables, the popular set the top
    ``pop_percent`` of ids by interaction count (MF.py:272-289); per
    minibatch the discriminators take a popular batch (label 1) and a rare
    batch (label 0) step (MF.py:127-153), then the recommender trains with
    ``loss_weights=[1, w, w]`` on swapped labels (MF.py:159-189);
  * ``AdversarialBPR`` (BPR.py:105-176), the same over the BPR base;
  * ``AdversarialNeuMF`` (NeuMF.py:58-185), four discriminators (MF-u,
    MF-i, MLP-u, MLP-i).

One wrapper serves them all: any base with ``adv_encoders()`` (name →
(side, fn(params, ids), width)). Each step takes the discriminators' Adam
step first, then the recommender's step against the updated discriminators
(AMF, ABPR, ANeuMF) or, with ``simultaneous=True`` (AMF2, the reference's
FastAdversarialMF.py:64-74), against the ones from before that update. The
recommender's gradient holds the discriminators constant, and the
discriminators' gradient the embeddings.

Scoring, the loss and the factored scorer delegate to the base, so AMF and
ABPR evaluate through K1 and ANeuMF through the dense path.

Under a mesh (``make_epoch_fn(..., mesh=)`` on the data-parallel copy) every
rank draws the global batch, its negatives, the pools' ids and the
label-swapped halves, and takes its data rank's rows of each (of the halves
joined end to end, so their labels go with them); each player's loss is the
rank's share and each player's gradient is summed over the data ranks
before its update.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from acf_tpu_torch.data.datasets import Interactions
from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import PairwiseModel, softplus
from acf_tpu_torch.nn.layers import dense, init_dense
from acf_tpu_torch.sampling.negatives import (
    negatives_from_draws, sample_pair_epoch, uniform_negatives,
)
from acf_tpu_torch.train.optim import adam, grad_update, player, whole
from acf_tpu_torch.train.trainer import _add_stats, _data_parallel, _mean_stats
from acf_tpu_torch.utils.tree import tree_map

# the discriminator step's pool draws, [B] each, and the recommender step's
# label-swapped halves, [B // 2] each: (draw name, pool), in draw order
POOL_DRAWS = (("pop_u", "pop_u"), ("pop_i", "pop_i"), ("rare_u", "rare_u"),
              ("rare_i", "rare_i"))
ADV_DRAWS = (("adv_pop_u", "pop_u"), ("adv_rare_u", "rare_u"), ("adv_pop_i", "pop_i"),
             ("adv_rare_i", "rare_i"))


def _bce_with_logits(logits, labels):
    return torch.mean(softplus(logits) - labels * logits)


def disc_forward(dp, x):
    """2-layer MLP discriminator: dim → dim (relu) → 1 logit
    (reference MF.py:262-270)."""
    h = torch.relu(dense(dp["l1"], x))
    return dense(dp["l2"], h)[..., 0]


def popularity_split(counts: np.ndarray, pop_percent: float):
    """ids sorted by count desc; first ``pop_percent`` fraction are popular
    (reference MF.py:272-289). Only ids with count > 0 participate."""
    ids = np.nonzero(counts > 0)[0]
    order = ids[np.argsort(-counts[ids], kind="stable")]
    k = int(len(order) * pop_percent)
    popular = order[:max(k, 1)]
    rare = order[max(k, 1):]
    if len(rare) == 0:
        rare = popular
    return popular.astype(np.int32), rare.astype(np.int32)


@dataclasses.dataclass(eq=False)
class PopularityAdversarial(PairwiseModel):
    """Wrap ``base`` with popularity discriminators on its embedding towers."""

    base: Any = None
    weight: float = 0.001       # reference --w
    pop_percent: float = 0.2    # reference --pp
    disc_lr: float = 0.001      # keras Adam default
    # True = FastAdversarialMF semantics (both players step from the same
    # pre-update parameters); False = the AMF/ABPR sequential protocol
    # (discriminators first, reference MF.py:118-190)
    simultaneous: bool = False

    def __post_init__(self):
        if not hasattr(self.base, "adv_encoders"):
            raise ValueError(f"{type(self.base).__name__} does not expose adv_encoders()")
        if hasattr(self.base, "eval_batch_users"):
            self.eval_batch_users = self.base.eval_batch_users
        self.repr_reads_table = self.base.repr_reads_table

    @property
    def encoders(self):
        """The base's ``adv_encoders()``, cached on the instance (and left
        out when it pickles: they are closures)."""
        if not hasattr(self, "_encoders"):
            self._encoders = self.base.adv_encoders()
        return self._encoders

    # -- params -------------------------------------------------------------
    def init_params(self, generator: torch.Generator, device=None):
        """``{"base": the base's params, "disc": {encoder: {"l1", "l2"}}}``,
        glorot kernels and zero biases for the discriminators."""
        dev = resolve_device(device)
        base = self.base.init_params(generator, dev)
        disc = {name: {"l1": init_dense(generator, edim, edim),
                       "l2": init_dense(generator, edim, 1)}
                for name, (_, _, edim) in self.encoders.items()}
        return {"base": base, "disc": tree_map(lambda x: x.to(dev), disc)}

    def init_opt_state(self, optimizer, params):
        return {"base": optimizer.init(params["base"]),
                "disc": self.disc_optimizer().init(params["disc"])}

    def opt_state_rows(self, optimizer, rows):
        """Where each leaf of :meth:`init_opt_state` lives (the
        optimizers' ``state_rows``)."""
        return {"base": optimizer.state_rows(rows["base"]),
                "disc": self.disc_optimizer().state_rows(rows["disc"])}

    def disc_optimizer(self):
        return adam(self.disc_lr)

    # -- data hooks ---------------------------------------------------------
    def extra_device_data(self, data: Interactions):
        """The popular and rare id pools of users and items, by their counts
        in the unique train pairs; the trainer puts them on its device."""
        user_counts = np.bincount(data.pairs_u, minlength=data.num_users)
        item_counts = np.bincount(data.pairs_i, minlength=data.num_items)
        pu, ru = popularity_split(user_counts, self.pop_percent)
        pi, ri = popularity_split(item_counts, self.pop_percent)
        return {"pop_u": pu, "rare_u": ru, "pop_i": pi, "rare_i": ri}

    # -- scoring delegates --------------------------------------------------
    def score_all(self, params, users, hists):
        return self.base.score_all(params["base"], users, hists)

    def score_some(self, params, users, hists, items):
        return self.base.score_some(params["base"], users, hists, items)

    def loss(self, params, batch, generator=None):
        return self.base.loss(params["base"], batch, generator)

    def factored_scorer(self):
        if not hasattr(self, "_fs"):
            base_fs = self.base.factored_scorer()
            if base_fs is None:
                self._fs = None
            else:
                ur, tb = base_fs
                self._fs = (lambda params, users, hists: ur(params["base"], users, hists),
                            lambda params: tb(params["base"]))
        return self._fs

    # -- the two steps ------------------------------------------------------
    def _enc_ids(self, kind, ids):
        return ids["u" if kind == "user" else "i"]

    def _bce(self, logits, labels):
        return self.data_share(_bce_with_logits(logits, labels))

    def disc_loss(self, disc_params, base_params, pop_ids, rare_ids):
        """Mean BCE of every discriminator on the popular (label 1) and the
        rare (label 0) embeddings, held constant (under a mesh, the rank's
        share)."""
        total = 0.0
        for name, (kind, enc, _) in self.encoders.items():
            pop = enc(base_params, self._enc_ids(kind, pop_ids)).detach()
            rare = enc(base_params, self._enc_ids(kind, rare_ids)).detach()
            dp = disc_params[name]
            total = total + self._bce(disc_forward(dp, pop), torch.ones_like(pop[:, 0]))
            total = total + self._bce(disc_forward(dp, rare), torch.zeros_like(rare[:, 0]))
        return total / (2 * len(self.encoders))

    def rec_loss(self, base_params, disc_params, batch, adv_ids, generator=None):
        """The base's loss plus ``weight`` times every discriminator's BCE
        on swapped labels (the popular half labelled 0, the rare half 1;
        reference MF.py:179-189), the discriminators held constant. Under a
        mesh ``adv_ids`` are this data rank's rows of the two halves joined
        end to end, and so are the labels. Returns (loss, the base's aux)."""
        main, aux = self.base.loss(base_params, batch, generator)
        adv = 0.0
        for name, (kind, enc, _) in self.encoders.items():
            ids = self._enc_ids(kind, adv_ids)
            n = self.data_count(ids.shape[0])
            y = torch.cat([torch.zeros(n // 2, device=ids.device),
                           torch.ones(n // 2, device=ids.device)])
            if self.data_mesh is not None:
                y = y[self.data_mesh.rows(n)]
            dp = tree_map(lambda x: x.detach(), disc_params[name])
            adv = adv + self._bce(disc_forward(dp, enc(base_params, ids)), y)
        return main + self.weight * adv, aux

    def train_step(self, optimizer, params, opt_state, batch, pop_ids, rare_ids, adv_ids,
                   generator=None, reduce=None):
        """One step: the discriminators' Adam step on the pools' ids, then
        the recommender's ``optimizer`` step, each gradient through
        ``reduce`` when given (the sum over the data ranks). Returns
        (params, opt_state, aux with ``d_loss``). Under sharded storage
        (``optimizer`` a :class:`~acf_tpu_torch.train.optim.Sharded`) each
        player reads the other's leaves gathered whole, each gathered once a
        step."""
        d_optim, b_optim = (player(optimizer, "disc", self.disc_optimizer()),
                            player(optimizer, "base"))
        base_fixed = whole(b_optim, params["base"])
        disc_new, d_opt, d_loss, _ = grad_update(
            d_optim, params["disc"], opt_state["disc"],
            lambda dp: (self.disc_loss(dp, base_fixed, pop_ids, rare_ids), None), reduce)
        disc_for_g = whole(d_optim, params["disc"] if self.simultaneous else disc_new)
        base_new, b_opt, _, aux = grad_update(
            b_optim, params["base"], opt_state["base"],
            lambda bp: self.rec_loss(bp, disc_for_g, batch, adv_ids, generator), reduce,
            read=base_fixed)
        aux = dict(aux)
        aux["d_loss"] = d_loss
        return {"base": base_new, "disc": disc_new}, {"base": b_opt, "disc": d_opt}, aux

    # -- the epoch ----------------------------------------------------------
    def make_epoch_fn(self, optimizer, batch_size: int, num_batches: int, dev=None,
                      mesh=None):
        """``epoch_fn(params, opt_state, data, generator, batches=None,
        cands=None, draws=None) -> (params, opt_state, stats)``. Per step,
        in the JAX package's order: the negatives, the four pool draws of
        ``batch_size`` ids for the discriminator step, its update, the four
        label-swapped draws of ``batch_size // 2`` ids, the recommender's
        update. ``batches`` [num_batches, batch_size] (pair indices),
        ``cands`` [num_batches, R, batch_size] (negative candidates) and
        ``draws`` (a dict of index draws into the pools, ``POOL_DRAWS`` [num_batches,
        batch_size] and ``ADV_DRAWS`` [num_batches, batch_size // 2])
        replace the draws from ``generator`` when given. With ``mesh``
        (``self`` then :func:`~acf_tpu_torch.models.base.data_parallel`'s
        copy) each step takes this data rank's rows of every draw, so both
        ``batch_size`` and ``batch_size // 2`` must divide over the data
        axis."""
        half = batch_size // 2
        rows, reduce = _data_parallel(mesh, batch_size)
        if mesh is not None and half % mesh.shape["data"]:
            raise ValueError(f"the label-swapped halves of {half} ids (batch {batch_size} // 2) "
                             f"do not divide over a {mesh.shape['data']}-way data axis")
        adv_rows = rows if mesh is None else mesh.rows(2 * half)

        def draw(data, generator, draws, step, name, pool, n):
            if draws is not None:
                return data[pool][draws[name][step]]
            idx = torch.randint(0, data[pool].shape[0], (n,), generator=generator,
                                device=generator.device)
            return data[pool][idx]

        def epoch_fn(params, opt_state, data, generator, batches=None, cands=None,
                     draws=None):
            if batches is None:
                batches = sample_pair_epoch(generator, data["pairs_u"].shape[0], batch_size,
                                            num_batches)
            sums = {}
            for step in range(num_batches):
                idx = batches[step]
                u, pos = data["pairs_u"][idx], data["pairs_i"][idx]
                hist_rows = data["hist"][u]
                neg = (uniform_negatives(generator, hist_rows, self.num_items) if cands is None
                       else negatives_from_draws(cands[step], hist_rows))
                ids = {name: draw(data, generator, draws, step, name, pool, batch_size)[rows]
                       for name, pool in POOL_DRAWS}
                pop_ids = {"u": ids["pop_u"], "i": ids["pop_i"]}
                rare_ids = {"u": ids["rare_u"], "i": ids["rare_i"]}
                # the recommender's draws (the discriminator step draws nothing)
                adv = {name: draw(data, generator, draws, step, name, pool, half)
                       for name, pool in ADV_DRAWS}
                adv_ids = {"u": torch.cat([adv["adv_pop_u"], adv["adv_rare_u"]])[adv_rows],
                           "i": torch.cat([adv["adv_pop_i"], adv["adv_rare_i"]])[adv_rows]}
                params, opt_state, aux = self.train_step(
                    optimizer, params, opt_state, (u[rows], pos[rows], neg[rows]), pop_ids,
                    rare_ids, adv_ids, generator, reduce)
                _add_stats(sums, aux)
            return params, opt_state, _mean_stats(sums, num_batches, mesh)

        return epoch_fn
