"""DSIN: Deep Session Interest Network (the port of
``acf_tpu/models/dsin.py``).

The IJCAI'19 DSIN architecture as the JAX package implements it:

  * sessions: the right-aligned history window [B, S·Ls] split into S
    sessions of Ls items;
  * interest extractor: per-session self-attention (shared Q/K/V) over
    the items plus a factored bias encoding (session + position + dim),
    pads masked with -1e9, then a masked mean-pool;
  * interest evolution: a GRU (TF semantics, :mod:`acf_tpu_torch.nn.rnn`)
    over the sessions, empty sessions skipped; with ``bi_evolution`` a
    second GRU runs backward and the two are summed;
  * activation units: softmax attention of the candidate item over the raw
    and the evolved interests;
  * DNN [d, d, d] with ReLU and dropout over
    [user ; item ; act(raw) ; act(evolved)] → logit.

Training: pointwise sigmoid CE (``bce``) or pairwise BPR (``bpr``) on the
window's last (history → next item) pair with one negative, plus ``l2_emb``
times the squared norm of the embedding rows the batch touches (duplicates
counted) over the batch size. Scores do not factor, so evaluation is dense:
chunks of 2,048 items for tiles of ``eval_batch_users`` users.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import SequenceModel, softplus
from acf_tpu_torch.nn.layers import dense, glorot_uniform, init_dense, trunc_normal
from acf_tpu_torch.nn.layers import dropout as inverted_dropout
from acf_tpu_torch.nn.rnn import gru_cell, init_gru, run_rnn
from acf_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(eq=False)
class DSIN(SequenceModel):
    sess_count: int = 5   # S sessions ...
    sess_len: int = 10    # ... of Ls items; maxlen is forced to S*Ls
    # capacity control (the JAX package's Video sweep): dropout on the DNN
    # hidden layers in training, L2 on the embedding rows a batch touches
    dropout: float = 0.5
    l2_emb: float = 1e-4
    loss_type: str = "bce"  # "bce" (pointwise, DSIN.py:50-73) or "bpr" (pairwise)
    bi_evolution: bool = False  # a backward GRU over the sessions, sum-merged

    eval_batch_users = 128
    _item_chunk = 2048

    def __post_init__(self):
        if self.loss_type not in ("bce", "bpr"):
            raise ValueError(f"DSIN loss_type must be 'bce' or 'bpr', got {self.loss_type!r}")
        self.maxlen = self.sess_count * self.sess_len

    def init_params(self, generator: torch.Generator, device=None):
        dev = resolve_device(device)
        d, g = self.dim, generator
        item = trunc_normal(g, (self.num_items, d), 0.01)
        item[0] = 0.0
        params = {
            "user_emb": trunc_normal(g, (self.num_users, d), 0.01),
            "item_emb": item,
            # the bias encoding over (session, position, dim), stored factored
            "b_sess": torch.zeros(self.sess_count, 1, 1, device=g.device),
            "b_pos": torch.zeros(1, self.sess_len, 1, device=g.device),
            "b_dim": torch.zeros(1, 1, d, device=g.device),
            "wq": init_dense(g, d, d),
            "wk": init_dense(g, d, d),
            "wv": init_dense(g, d, d),
            "gru": init_gru(g, d, d),
            "act_w1": glorot_uniform(g, (d, d)),  # raw-interest activation
            "act_w2": glorot_uniform(g, (d, d)),  # evolved activation
            "dnn1": init_dense(g, 4 * d, d),
            "dnn2": init_dense(g, d, d),
            "dnn3": init_dense(g, d, d),
            "out": init_dense(g, d, 1),
        }
        if self.bi_evolution:
            params["gru_bwd"] = init_gru(g, d, d)
        return tree_map(lambda x: x.to(dev), params)

    # ------------------------------------------------------------------
    def _interests(self, params, seq):
        """[B, S·Ls] history → (raw [B, S, d], evolved [B, S, d],
        sess_mask [B, S])."""
        b = seq.shape[0]
        S, Ls, d = self.sess_count, self.sess_len, self.dim
        sess = seq.reshape(b, S, Ls)
        mask = sess != 0  # [B, S, Ls]
        x = params["item_emb"][sess] + (params["b_sess"] + params["b_pos"] + params["b_dim"])[None]
        q, k, v = (dense(params[w], x) for w in ("wq", "wk", "wv"))
        scores = torch.einsum("bsqd,bskd->bsqk", q, k) / math.sqrt(d)
        probs = torch.softmax(torch.where(mask[:, :, None, :], scores, -1e9), dim=-1)
        att = torch.einsum("bsqk,bskd->bsqd", probs, v) * mask[..., None]
        denom = torch.clamp(mask.sum(-1, keepdim=True), min=1)  # [B, S, 1]
        sess_mask = mask.any(-1)  # [B, S]
        raw = att.sum(2) / denom * sess_mask[..., None]  # masked mean-pool
        h0 = torch.zeros(b, d, device=seq.device)
        _, evolved = run_rnn(gru_cell, params["gru"], raw, sess_mask, h0)
        if self.bi_evolution:
            _, back = run_rnn(gru_cell, params["gru_bwd"], raw.flip(1), sess_mask.flip(1), h0)
            evolved = evolved + back.flip(1)
        return raw, evolved, sess_mask

    @staticmethod
    def _activation_pool(interests, sess_mask, w, item_e):
        """softmax_s(interest_s · W · item) pooled interests: interests
        [B, S, d], item_e [B, M, d] → [B, M, d]."""
        logits = torch.einsum("bsd,bmd->bms", interests @ w, item_e)
        probs = torch.softmax(torch.where(sess_mask[:, None, :], logits, -1e9), dim=-1)
        return torch.einsum("bms,bsd->bmd", probs, interests)

    def dropout_masks(self, generator: torch.Generator, batch):
        """The three DNN layers' keep-masks [B, 2, d] of one training pass
        (True = kept, probability 1 - dropout), drawn on the generator's
        device."""
        if generator is None:
            raise ValueError("dropout needs a torch.Generator or injected masks")
        shape = (batch[0].shape[0], 2, self.dim)
        return [torch.rand(shape, generator=generator, device=generator.device)
                < 1.0 - self.dropout for _ in range(3)]

    def train_masks(self, generator, batch):
        """The DNN's masks of one training pass (none without dropout)."""
        return (self.dropout_masks(generator, batch) if self.dropout > 0.0 else None), None

    def _head(self, params, users, interests, items, train: bool = False, generator=None,
              masks=None):
        """Logits [B, M] of ``items`` [B, M] given the session interests;
        with ``train``, dropout after each DNN layer (``masks`` or drawn from
        ``generator``)."""
        raw, evolved, sess_mask = interests
        item_e = params["item_emb"][items]  # [B, M, d]
        u_raw = self._activation_pool(raw, sess_mask, params["act_w1"], item_e)
        u_ev = self._activation_pool(evolved, sess_mask, params["act_w2"], item_e)
        u_e = params["user_emb"][users][:, None, :].expand_as(item_e)
        h = torch.cat([u_e, item_e, u_raw, u_ev], dim=-1)
        train = train and self.dropout > 0.0
        if train and masks is None:
            masks = self.dropout_masks(generator, (users,))
        for i, layer in enumerate(("dnn1", "dnn2", "dnn3")):
            h = torch.relu(dense(params[layer], h))
            h = inverted_dropout(h, self.dropout, train, mask=masks[i] if train else None)
        return dense(params["out"], h)[..., 0]

    def _window(self, hists):
        """The last ``maxlen`` history items, left-padded with 0 when the
        history is narrower (the JAX package's pad, ``dsin.py:238-239``)."""
        seq = hists[:, -self.maxlen:]
        return F.pad(seq, (self.maxlen - seq.shape[1], 0))

    # ------------------------------------------------------------------
    def loss(self, params, batch, generator=None, masks=None):
        """On the window's last position: ``(users, seq, pos, neg)``, its
        next item ``pos[:, -1]`` against ``neg[:, -1]``."""
        users, seq, pos, neg = batch
        pos_t, neg_t = pos[:, -1], neg[:, -1]
        logits = self._head(params, users, self._interests(params, seq),
                            torch.stack([pos_t, neg_t], dim=1), train=True,
                            generator=generator, masks=masks)  # [B, 2]
        valid = (pos_t != 0).to(torch.float32)
        n = torch.clamp(self.data_sum(valid.sum()), min=1.0)  # the global count
        if self.loss_type == "bpr":
            per = softplus(-(logits[:, 0] - logits[:, 1]))
        else:
            per = softplus(-logits[:, 0]) + softplus(logits[:, 1])
        loss = torch.sum(per * valid) / n
        acc = torch.sum((logits[:, 0] > logits[:, 1]) * valid) / n
        if self.l2_emb > 0.0:
            # the rows this batch touches (a sparse-equivalent decay): the
            # user row, the history window and the candidate pair
            emb = params["item_emb"]
            reg = (torch.sum(torch.square(params["user_emb"][users]))
                   + torch.sum(torch.square(emb[seq])) + torch.sum(torch.square(emb[pos_t]))
                   + torch.sum(torch.square(emb[neg_t])))
            loss = loss + self.l2_emb * reg / max(float(self.data_count(users.shape[0])), 1.0)
        return loss, {"loss": loss, "acc": acc}

    def score_all(self, params, users, hists):
        """[B, num_items] in chunks of ``_item_chunk`` items, the session
        interests computed once."""
        interests = self._interests(params, self._window(hists))
        b = users.shape[0]
        chunks = []
        for s in range(0, self.num_items, self._item_chunk):
            items = torch.arange(s, min(s + self._item_chunk, self.num_items),
                                 device=users.device)
            chunks.append(self._head(params, users, interests, items[None, :].expand(b, -1)))
        return torch.cat(chunks, dim=1)

    def score_some(self, params, users, hists, items):
        return self._head(params, users, self._interests(params, self._window(hists)), items)
