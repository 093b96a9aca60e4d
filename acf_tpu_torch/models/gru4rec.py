"""GRU4Rec: session-based GRU recommendation with in-batch negatives (the
port of ``acf_tpu/models/gru4rec.py``).

The reference (GRU4Rec.py:43-330) trains a stateful GRU over
session-parallel minibatches; here each right-aligned window of the last
``maxlen`` items runs through the recurrence at once (:func:`run_rnn`),
which is the same unrolled recurrence. At every step the batch's target
items are the candidate set (GRU4Rec.py:152-162): ``bpr`` = mean
-log σ(ŷ_ii − ŷ_ij), ``top1`` = mean σ(ŷ_ij − ŷ_ii) + σ(ŷ_ij²) less the
self term, ``ce`` = softmax cross-entropy over the in-batch targets. Pad
positions are masked out of the loss and freeze the state.

Evaluation: with the linear output (the default) scores factor as
``h_last · W + b``, so :meth:`factored_scorer` routes full-catalog ranking
through the rank-count kernel (K1); a relu or tanh output changes the tie
structure, and the model then ranks densely through ``score_all``, as the
JAX package does. :meth:`init_state` / :meth:`step_state` are the
streaming API that :class:`acf_tpu_torch.ops.topk.SessionStream` serves.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import SequenceModel
from acf_tpu_torch.nn.rnn import gru_cell, init_gru, run_rnn
from acf_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(eq=False)
class GRU4Rec(SequenceModel):
    loss_type: str = "bpr"       # 'bpr' | 'top1' | 'ce' (GRU4Rec.py:100-123)
    final_act: str = "linear"    # 'linear' | 'relu' | 'tanh'
    hidden_act: str = "tanh"

    def __post_init__(self):
        if self.loss_type not in ("bpr", "top1", "ce"):
            raise ValueError(f"gru4rec loss_type {self.loss_type!r} not in "
                             "('bpr', 'top1', 'ce')")
        if self.final_act not in ("linear", "relu", "tanh"):
            raise ValueError(f"gru4rec final_act {self.final_act!r}")
        if self.hidden_act not in ("tanh", "relu"):
            raise ValueError(f"gru4rec hidden_act {self.hidden_act!r}")

    def _act(self, x):
        if self.final_act == "relu":
            return torch.relu(x)
        if self.final_act == "tanh":
            return torch.tanh(x)
        return x

    def _cell_act(self):
        return torch.tanh if self.hidden_act == "tanh" else torch.relu

    def init_params(self, generator: torch.Generator, device=None):
        """``emb`` and ``W`` uniform in ±sqrt(6 / (num_items + d))
        (GRU4Rec.py:172-176), the GRU, and a zero output bias ``b``."""
        dev = resolve_device(device)
        d = self.dim
        sigma = math.sqrt(6.0 / (self.num_items + d))

        def uniform():
            x = torch.empty(self.num_items, d, device=generator.device)
            return x.uniform_(-sigma, sigma, generator=generator)

        params = {"emb": uniform(), "gru": init_gru(generator, d, d), "W": uniform(),
                  "b": torch.zeros(self.num_items, device=generator.device)}
        return tree_map(lambda x: x.to(dev), params)

    def _hidden_states(self, params, seq):
        """[B, T] → the state after every step, [B, T, d]."""
        act = self._cell_act()
        h0 = torch.zeros(seq.shape[0], self.dim, device=seq.device)
        _, hs = run_rnn(lambda p, x, h: gru_cell(p, x, h, activation=act), params["gru"],
                        params["emb"][seq], seq != 0, h0)
        return hs

    def loss(self, params, batch, generator=None):
        """Loss over the in-batch logits [T, B, B]; ``neg`` is unused (the
        other rows' targets are the negatives). Draws nothing. Under a mesh
        the rows are this data rank's and the candidate columns the global
        batch's targets (:meth:`data_gather`), so each (row, column) pair of
        the global batch is counted on one rank, against the global
        counts."""
        users, seq, pos, neg = batch
        hs = self._hidden_states(params, seq)  # [B, T, d] (this rank's rows)
        cols = self.data_gather(pos)  # [B_global, T]: the candidate targets
        b = cols.shape[0]
        start = 0 if self.data_mesh is None else self.data_mesh.rows(b).start
        w = params["W"][cols]  # [B_global, T, d] target output embeddings
        bias = params["b"][cols]  # [B_global, T]
        # yhat[t, i, j] = h_i(t) · w_j(t) + b_j(t)
        yhat = self._act(torch.einsum("itd,jtd->tij", hs, w) + bias.T[:, None, :])
        valid = (pos != 0).T  # [T, B]
        # a (step, row) counts iff its own target is valid; the candidate
        # columns are the valid targets of the same step
        pair_ok = (cols != 0).T[:, None, :] & valid[:, :, None]  # [T, i, j]
        n_pairs = torch.clamp(self.data_sum(pair_ok.sum().to(torch.float32)), min=1.0)
        n_valid = torch.clamp(self.data_sum(valid.sum().to(torch.float32)), min=1.0)
        diag = torch.diagonal(yhat, offset=start, dim1=1, dim2=2)  # [T, B]: row i's own target
        if self.loss_type == "bpr":
            lt = -torch.log(torch.sigmoid(diag[:, :, None] - yhat) + 1e-24)
            loss = torch.sum(lt * pair_ok) / n_pairs
        elif self.loss_type == "top1":
            term = torch.sigmoid(yhat - diag[:, :, None]) + torch.sigmoid(torch.square(yhat))
            corr = torch.sigmoid(torch.square(diag)) / b  # remove the self term
            loss = torch.sum(term * pair_ok) / n_pairs - torch.sum(corr * valid) / n_valid
        else:  # cross-entropy over the in-batch targets
            logp = torch.log_softmax(torch.where(pair_ok, yhat, -1e9), dim=-1)
            ld = -torch.diagonal(logp, offset=start, dim1=1, dim2=2)
            loss = torch.sum(ld * valid) / n_valid
        acc = torch.sum((diag[:, :, None] > yhat) & pair_ok) / n_pairs
        return loss, {"loss": loss, "acc": acc}

    def _last_state(self, params, hists):
        return self._hidden_states(params, hists[:, -self.maxlen:])[:, -1, :]

    def score_all(self, params, users, hists):
        return self._act(self._last_state(params, hists) @ params["W"].T + params["b"])

    def score_some(self, params, users, hists, items):
        h_last = self._last_state(params, hists)
        return self._act(torch.einsum("bd,bmd->bm", h_last, params["W"][items])
                         + params["b"][items])

    # -- the streaming session API (reference predict_next_batch,
    # GRU4Rec.py:285-327): the state carried across events -----------------
    def init_state(self, batch_size: int, device=None):
        return torch.zeros(batch_size, self.dim, device=resolve_device(device))

    def step_state(self, params, state, items, reset_mask=None):
        """One streaming step: consume one item per session and return the
        new state [B, d] and the next-item scores [B, num_items].

        ``items`` [B] (0 = no event: the state is kept); ``reset_mask`` [B]
        bool, True resets that session's state first (a session change,
        GRU4Rec.py:314-318)."""
        if reset_mask is not None:
            state = torch.where(reset_mask[:, None], 0.0, state)
        new = gru_cell(params["gru"], params["emb"][items], state, activation=self._cell_act())
        state = torch.where((items != 0)[:, None], new, state)
        return state, self._act(state @ params["W"].T + params["b"])

    def factored_scorer(self):
        # a relu or tanh output changes the tie structure, so the factored
        # path is rank-exact only for the (default) linear output
        if self.final_act != "linear":
            return None
        if not hasattr(self, "_fs"):
            def table(params):
                return params["W"], params["b"]

            self._fs = (lambda params, users, hists: self._last_state(params, hists), table)
        return self._fs
