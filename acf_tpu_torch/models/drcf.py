"""DRCF: Dynamic Recurrent Collaborative Filtering (the port of
``acf_tpu/models/drcf.py``).

Reference DRCF.py:15-215: GMF and MLP towers, each with a static user
embedding, an item embedding and an RNN-encoded sequence ("dynamic user")
embedding, each split again into a dot-product branch and an element-wise
branch (four SimpleRNNs: MF and DOT-MF at width d, MLP and DOT-MLP at d/2,
DRCF.py:51-57, 104-110). The MLP branch runs [1 + 3h → 3d → 2d → d] with
ReLU, and its output and the MF branch's feed a linear prediction;
training is the BPR triplet objective (DRCF.py:151-167).

Scores do not factor, so evaluation is dense: ``score_all`` scores the
catalog in chunks of 2,048 items for tiles of ``eval_batch_users`` users.
The last chunk holds only the real items (the JAX package pads it by
repeating the last id and drops the padding after).
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import SequenceModel, softplus
from acf_tpu_torch.nn.layers import dense, init_dense, trunc_normal
from acf_tpu_torch.nn.rnn import init_simple_rnn, run_rnn, simple_rnn_cell
from acf_tpu_torch.utils.tree import tree_map

# (tower, its sequence table, its RNN)
TOWERS = (("mf", "mf_c", "rnn_mf"), ("dot_mf", "dot_mf_c", "rnn_dot_mf"),
          ("mlp", "mlp_c", "rnn_mlp"), ("dot_mlp", "dot_mlp_c", "rnn_dot_mlp"))


@dataclasses.dataclass(eq=False)
class DRCF(SequenceModel):
    eval_batch_users = 128
    _item_chunk = 2048

    def init_params(self, generator: torch.Generator, device=None):
        """Twelve tables truncnormal(0.01) (DRCF.py:11-12), the four RNNs and
        the MLP's dense layers, in the JAX tree's names."""
        dev = resolve_device(device)
        d, h, g = self.dim, self.dim // 2, generator
        params = {}
        for tower, width in (("mf", d), ("dot_mf", d), ("mlp", h), ("dot_mlp", h)):
            for side, n in (("u", self.num_users), ("i", self.num_items), ("c", self.num_items)):
                params[f"{tower}_{side}"] = trunc_normal(g, (n, width), 0.01)
        params.update({
            "rnn_mf": init_simple_rnn(g, d, d),
            "rnn_dot_mf": init_simple_rnn(g, d, d),
            "rnn_mlp": init_simple_rnn(g, h, h),
            "rnn_dot_mlp": init_simple_rnn(g, h, h),
            # MLP layers [d, 3d, 2d, d] → dense widths 3d, 2d, d over the
            # input [1 + 3h] (DRCF.py:25, 128-137)
            "l1": init_dense(g, 1 + 3 * h, 3 * d),
            "l2": init_dense(g, 3 * d, 2 * d),
            "l3": init_dense(g, 2 * d, d),
            "out": init_dense(g, (1 + d) + d, 1),
        })
        return tree_map(lambda x: x.to(dev), params)

    # ------------------------------------------------------------------
    def _dyn_states(self, params, seq, last_only: bool):
        """The four towers' RNN states over the window: [B, T, ·] each, or
        [B, ·] with ``last_only``."""
        out = {}
        for name, table, rnn in TOWERS:
            xs = params[table][seq]
            h0 = torch.zeros(seq.shape[0], xs.shape[-1], device=seq.device)
            h_final, hs = run_rnn(simple_rnn_cell, params[rnn], xs, seq != 0, h0)
            out[name] = h_final if last_only else hs
        return out

    def _predict(self, params, dyn, u_static, items):
        """Scores of ``items`` given the dynamic states and static user
        embeddings; every leading dim broadcasts (dyn and u_static
        [..., width], items [...] int)."""
        mf_i = params["mf_i"][items]
        dot_mf_i = params["dot_mf_i"][items]
        mlp_i = params["mlp_i"][items]
        dot_mlp_i = params["dot_mlp_i"][items]
        lead = torch.broadcast_shapes(items.shape, *(v.shape[:-1] for v in dyn.values()),
                                      *(v.shape[:-1] for v in u_static.values()))

        def bc(x):
            return x.expand(*lead, x.shape[-1])

        dot_scalar = torch.sum((dyn["dot_mf"] + u_static["dot_mf_u"]) * dot_mf_i, -1,
                               keepdim=True)
        mf_vec = torch.cat([bc(dot_scalar), bc(dyn["mf"] * u_static["mf_u"] * mf_i)], -1)
        mlp_dot_scalar = torch.sum((dyn["dot_mlp"] + u_static["dot_mlp_u"]) * dot_mlp_i, -1,
                                   keepdim=True)
        mlp_vec = torch.cat([bc(mlp_dot_scalar), bc(dyn["mlp"]), bc(u_static["mlp_u"]),
                             bc(mlp_i)], -1)
        mlp_vec = torch.relu(dense(params["l1"], mlp_vec))
        mlp_vec = torch.relu(dense(params["l2"], mlp_vec))
        mlp_vec = torch.relu(dense(params["l3"], mlp_vec))
        return dense(params["out"], torch.cat([mf_vec, mlp_vec], -1))[..., 0]

    def _static(self, params, users):
        return {f"{k}_u": params[f"{k}_u"][users][:, None, :]
                for k in ("mf", "dot_mf", "mlp", "dot_mlp")}

    def loss(self, params, batch, generator=None):
        """1 − log σ(pos − neg) at every valid position (DRCF.py:151-158;
        the constant 1 is kept for the loss value). Draws nothing."""
        users, seq, pos, neg = batch
        dyn = self._dyn_states(params, seq, last_only=False)  # [B, T, ·]
        us = self._static(params, users)
        pos_s = self._predict(params, dyn, us, pos)
        neg_s = self._predict(params, dyn, us, neg)
        ist = (pos != 0).to(torch.float32)
        n = torch.clamp(self.data_sum(ist.sum()), min=1.0)  # the global count
        loss = torch.sum((1.0 + softplus(-(pos_s - neg_s))) * ist) / n
        acc = torch.sum((pos_s > neg_s) * ist) / n
        return loss, {"loss": loss, "acc": acc}

    def _last_states(self, params, hists):
        dyn = self._dyn_states(params, hists[:, -self.maxlen:], last_only=True)
        return {k: v[:, None, :] for k, v in dyn.items()}

    def score_all(self, params, users, hists):
        """[B, num_items] in chunks of ``_item_chunk`` items."""
        dyn, us = self._last_states(params, hists), self._static(params, users)
        chunks = []
        for s in range(0, self.num_items, self._item_chunk):
            items = torch.arange(s, min(s + self._item_chunk, self.num_items),
                                 device=users.device)
            chunks.append(self._predict(params, dyn, us, items[None, :]))
        return torch.cat(chunks, dim=1)

    def score_some(self, params, users, hists, items):
        return self._predict(params, self._last_states(params, hists),
                             self._static(params, users), items)
