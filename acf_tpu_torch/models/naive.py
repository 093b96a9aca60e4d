"""The naive baselines (counterpart of ``acf_tpu/models/naive.py``;
reference NaiveBaselines.py:6-77).

* MostPopular: the global item interaction counts.
* MostRecentlyVisit: 1 for the user's last train item, else 0.
* MostFrequentlyVisit: the user's own visit count of each item.
* AlreadyVisit: 1 for any item in the user's train set (the reference's CLI
  names it, run.py:17, 200-201, but never implements it; this is its
  evident intent, as in the JAX package).

They train nothing: the "params" are score tables baked from the dataset,
the epoch is a no-op (the reference stops after one, run.py:275-276) and
there is no optimizer state. None has a factored scorer, so the evaluator
takes its dense path. The scores are small integers, exact in float32, so
rank positions, ties included, equal the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acf_tpu_torch.data.datasets import Interactions
from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import PairwiseModel


@dataclasses.dataclass(eq=False)
class _NaiveBase(PairwiseModel):
    data: Interactions = None

    def init_params(self, generator: torch.Generator, device=None):
        return {"_": torch.zeros((), device=resolve_device(device))}

    def init_opt_state(self, optimizer, params):
        return ()

    def opt_state_rows(self, optimizer, rows):
        return ()

    def make_epoch_fn(self, optimizer, batch_size: int, num_batches: int, dev=None,
                      mesh=None):
        """The no-op epoch; a mesh changes nothing here and is ignored."""
        def epoch_fn(params, opt_state, data, generator):
            return params, opt_state, {"loss": 0.0, "acc": 0.0}

        return epoch_fn

    def loss(self, params, batch, generator=None):
        z = torch.zeros((), device=batch[0].device)
        return z, {"loss": z, "acc": z}


def _visit_counts(num_items, hists):
    """[B, I] float32: each user's visits of each item in ``hists`` [B, L],
    the pad column 0."""
    scores = torch.zeros(hists.shape[0], num_items, device=hists.device)
    scores.scatter_add_(1, hists.long(), (hists != 0).to(torch.float32))
    scores[:, 0] = 0.0
    return scores


@dataclasses.dataclass(eq=False)
class MostPopular(_NaiveBase):
    """Global popularity (NaiveBaselines.py:6-27)."""

    def init_params(self, generator: torch.Generator, device=None):
        # the raw interaction counts with duplicate visits (the reference
        # groups the whole frame, NaiveBaselines.py:9), not a bincount of
        # the unique pairs
        counts = self.data.item_count
        if counts is None:
            counts = np.bincount(self.data.pairs_i, minlength=self.num_items)
        return {"counts": torch.as_tensor(counts.astype(np.float32),
                                          device=resolve_device(device))}

    def score_all(self, params, users, hists):
        return params["counts"][None, :].expand(users.shape[0], self.num_items)

    def score_some(self, params, users, hists, items):
        return params["counts"][items]


@dataclasses.dataclass(eq=False)
class MostRecentlyVisit(_NaiveBase):
    """1 for the last visited item (NaiveBaselines.py:35-52)."""

    def score_all(self, params, users, hists):
        last = hists[:, -1].long()  # right-aligned: the last column is the latest
        scores = torch.zeros(users.shape[0], self.num_items, device=hists.device)
        scores[torch.arange(users.shape[0], device=hists.device), last] = 1.0
        return scores

    def score_some(self, params, users, hists, items):
        return (items == hists[:, -1:]).to(torch.float32)


@dataclasses.dataclass(eq=False)
class MostFrequentlyVisit(_NaiveBase):
    """Per-user visit counts (NaiveBaselines.py:54-77)."""

    def score_all(self, params, users, hists):
        return _visit_counts(self.num_items, hists)

    def score_some(self, params, users, hists, items):
        return (items[:, :, None] == hists[:, None, :]).sum(-1).to(torch.float32)


@dataclasses.dataclass(eq=False)
class AlreadyVisit(_NaiveBase):
    """Membership indicator (the intent of the reference's missing class)."""

    def score_all(self, params, users, hists):
        return (_visit_counts(self.num_items, hists) > 0).to(torch.float32)

    def score_some(self, params, users, hists, items):
        return (items[:, :, None] == hists[:, None, :]).any(-1).to(torch.float32)
