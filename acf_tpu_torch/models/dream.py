"""DREAM: a SimpleRNN over the interaction sequence with a BPR-style
objective (the port of ``acf_tpu/models/dream.py``).

Reference DREAM.py:9-91 (Keras) and DREAM_TF (DREAM.py:94-164): one item
table feeds the RNN, the hidden state scores items by dot product, and the
loss is BCE on σ(pos − neg) with label 1, i.e. softplus(−(pos − neg)). One
pass over the right-aligned window gives the state after every prefix, so
each (position t → next item) pair trains from the same recurrence.
Scores factor as ``h_last · emb``, so evaluation goes through K1.
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import SequenceModel, softplus
from acf_tpu_torch.nn.rnn import init_simple_rnn, run_rnn, simple_rnn_cell
from acf_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(eq=False)
class DREAM(SequenceModel):
    def init_params(self, generator: torch.Generator, device=None):
        """``emb`` uniform in ±0.05 with the pad row 0 zero (mask_zero,
        DREAM.py:21) and the SimpleRNN ``rnn``."""
        dev = resolve_device(device)
        emb = torch.empty(self.num_items, self.dim, device=generator.device)
        emb.uniform_(-0.05, 0.05, generator=generator)
        emb[0] = 0.0
        params = {"emb": emb, "rnn": init_simple_rnn(generator, self.dim, self.dim)}
        return tree_map(lambda x: x.to(dev), params)

    def _hidden_states(self, params, seq):
        h0 = torch.zeros(seq.shape[0], self.dim, device=seq.device)
        _, hs = run_rnn(simple_rnn_cell, params["rnn"], params["emb"][seq], seq != 0, h0)
        return hs

    def loss(self, params, batch, generator=None):
        users, seq, pos, neg = batch
        hs = self._hidden_states(params, seq)  # [B, T, d]
        pos_s = torch.sum(hs * params["emb"][pos], -1)
        neg_s = torch.sum(hs * params["emb"][neg], -1)
        ist = (pos != 0).to(torch.float32)
        n = torch.clamp(self.data_sum(ist.sum()), min=1.0)  # the global count
        # BCE(σ(pos − neg), 1) = softplus(−(pos − neg)) (DREAM.py:30-41)
        loss = torch.sum(softplus(-(pos_s - neg_s)) * ist) / n
        acc = torch.sum((pos_s > neg_s) * ist) / n
        return loss, {"loss": loss, "acc": acc}

    def _last_state(self, params, hists):
        return self._hidden_states(params, hists[:, -self.maxlen:])[:, -1, :]

    def score_all(self, params, users, hists):
        return self._last_state(params, hists) @ params["emb"].T

    def score_some(self, params, users, hists, items):
        return torch.einsum("bd,bmd->bm", self._last_state(params, hists),
                            params["emb"][items])

    def factored_scorer(self):
        if not hasattr(self, "_fs"):
            def table(params):
                return params["emb"], None

            self._fs = (lambda params, users, hists: self._last_state(params, hists), table)
        return self._fs
