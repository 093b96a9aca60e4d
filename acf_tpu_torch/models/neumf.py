"""NeuMF: GMF (element-wise product) + MLP tower → sigmoid prediction
(counterpart of ``acf_tpu/models/neumf.py``).

Reference NeuMF.py:10-56: separate MF and MLP embedding pairs, MLP layer
sizes [d, 2d, d] applied to the concatenated user/item MLP embeddings, final
1-unit sigmoid Dense over [gmf_vector ; mlp_vector]; pointwise binary
cross-entropy with one sampled negative per positive (MF.py:42-56). Adam.

The tower keeps scores from factoring into user and item tables, so NeuMF
has no factored scorer: the evaluator scores the full catalog through
:meth:`NeuMF.score_all` (item chunks of plain ``torch.matmul`` and
elementwise ops, as the JAX package computes it outside any Pallas kernel).
The adversarial variant (AdversarialNeuMF, NeuMF.py:58-185) is
:class:`acf_tpu_torch.adversarial.popularity.PopularityAdversarial` around
this model, on its four :meth:`NeuMF.adv_encoders`.
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import PairwiseModel, softplus
from acf_tpu_torch.nn.layers import dense, init_dense
from acf_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(eq=False)
class NeuMF(PairwiseModel):
    """dim == the reference's ``mf_dim``; MLP layers are [2d→2d, 2d→d]
    applied after concat (NeuMF.py:15, 40-42: layers [d, 2d, d] where
    layer 0 is the concat width d+d)."""

    init_scale = 0.05  # keras Embedding default: uniform(-0.05, 0.05)
    # the evaluator's user tile: the tower materializes [B, chunk, 2d]
    # activations per item chunk
    eval_batch_users = 128
    _item_chunk = 4096

    def init_params(self, generator: torch.Generator, device=None):
        """Keras-uniform embeddings and glorot-uniform dense kernels (zero
        biases), drawn from ``generator`` on its device."""
        dev = resolve_device(device)
        d = self.dim

        def uniform(rows):
            x = torch.empty((rows, d), dtype=torch.float32, device=generator.device)
            return x.uniform_(-self.init_scale, self.init_scale, generator=generator)

        params = {
            "P_mf": uniform(self.num_users),
            "Q_mf": uniform(self.num_items),
            "P_mlp": uniform(self.num_users),
            "Q_mlp": uniform(self.num_items),
            "mlp1": init_dense(generator, 2 * d, 2 * d),
            "mlp2": init_dense(generator, 2 * d, d),
            "out": init_dense(generator, 2 * d, 1),
        }
        return tree_map(lambda x: x.to(dev), params)

    @staticmethod
    def _tower(params, pu_mf, qi_mf, pu_mlp, qi_mlp):
        """Logits of gathered (broadcastable) rows: the GMF product and the
        MLP over [p_mlp ; q_mlp], concatenated into the output layer."""
        gmf = pu_mf * qi_mf
        shape = torch.broadcast_shapes(pu_mlp.shape, qi_mlp.shape)
        mlp = torch.cat([pu_mlp.expand(shape), qi_mlp.expand(shape)], dim=-1)
        mlp = torch.relu(dense(params["mlp1"], mlp))
        mlp = torch.relu(dense(params["mlp2"], mlp))
        vec = torch.cat([gmf, mlp], dim=-1)
        return dense(params["out"], vec)[..., 0]

    def _logits(self, params, users, items):
        return self._tower(params, params["P_mf"][users], params["Q_mf"][items],
                           params["P_mlp"][users], params["Q_mlp"][items])

    def loss(self, params, batch, generator=None):
        """Mean BCE over the 2B pointwise examples (pos labelled 1, neg 0);
        aux ``loss`` (the same value) and ``acc`` (pos logit above neg). Under
        a mesh both are this data rank's shares."""
        users, pos, neg = batch
        pos_l = self._logits(params, users, pos)
        neg_l = self._logits(params, users, neg)
        logits = torch.cat([pos_l, neg_l])
        labels = torch.cat([torch.ones_like(pos_l), torch.zeros_like(neg_l)])
        loss = self.data_share(torch.mean(softplus(logits) - labels * logits))
        acc = self.data_share(torch.mean(((pos_l - neg_l) > 0).to(torch.float32)))
        return loss, {"loss": loss, "acc": acc}

    def score_all(self, params, users, hists):
        """[B, num_items] logits, the catalog in chunks of ``_item_chunk``
        items: each chunk runs the tower on [B, chunk] (user, item) pairs."""
        pu_mf = params["P_mf"][users][:, None, :]
        pu_mlp = params["P_mlp"][users][:, None, :]
        num_items = params["Q_mf"].shape[0]
        out = []
        for s in range(0, num_items, self._item_chunk):
            e = min(s + self._item_chunk, num_items)
            out.append(self._tower(params, pu_mf, params["Q_mf"][None, s:e], pu_mlp,
                                   params["Q_mlp"][None, s:e]))
        return torch.cat(out, dim=1)

    def score_some(self, params, users, hists, items):
        """[B, M] logits of ``items`` [B, M] for each row's user."""
        return self._logits(params, users[:, None], items)

    def adv_encoders(self):
        """AdversarialNeuMF attaches 4 discriminators: MF-user, MF-item,
        MLP-user, MLP-item (reference NeuMF.py:71-100): name -> (side,
        fn(params, ids) -> [N, d], width)."""
        d = self.dim
        return {
            "mf_u": ("user", lambda p, ids: p["P_mf"][ids], d),
            "mf_i": ("item", lambda p, ids: p["Q_mf"][ids], d),
            "mlp_u": ("user", lambda p, ids: p["P_mlp"][ids], d),
            "mlp_i": ("item", lambda p, ids: p["Q_mlp"][ids], d),
        }
